"""The port's pair intersector (ops/intersect_pairs.py) against the JAX
package's on the CPU: the same 3000-triangle soup and rays, made with
numpy, give bit-equal candidate lists, bit-equal MT tiles (the Pallas
kernel in interpret mode), matching Pluecker tiles (the XLA twin of the
Pallas kernel sums in another order) and matching pipeline results; with
the blocklist fallback the port agrees with its brute oracle on every
ray."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
from mitsuba_path_guiding_torch.accel.bvh import build_bvh, to_device
from mitsuba_path_guiding_torch.accel.pairs import build_pair_table
from mitsuba_path_guiding_torch.accel.traverse import (
    intersect_brute,
    intersect_pairs_full,
    occluded_brute,
    occluded_pairs_full,
)
from mitsuba_path_guiding_torch.ops.intersect_pairs import (
    build_pair_lists,
    intersect_pairs_raw,
    mt_tiles,
    mt_tiles_plain,
    pair_tiles,
    plk_tiles_plain,
    sorted_pairs,
)
from mitsuba_path_guiding_torch.scene.types import Geometry
from mitsuba_path_guiding_tpu.accel.bvh import build_bvh as j_build_bvh
from mitsuba_path_guiding_tpu.accel.pairs import build_pair_table as j_build_pair_table
from mitsuba_path_guiding_tpu.ops import intersect_pairs as jpairs

INF = 3.0e38
N_RAYS = 2048


@pytest.fixture(scope="module")
def soup():
    rs = np.random.default_rng(3)
    T = 3000
    c = rs.uniform(-3, 3, (T, 3)).astype(np.float32)
    p0 = c + rs.normal(0, 0.15, (T, 3)).astype(np.float32)
    e1 = rs.normal(0, 0.3, (T, 3)).astype(np.float32)
    e2 = rs.normal(0, 0.3, (T, 3)).astype(np.float32)
    o = rs.uniform(-4.5, 4.5, (N_RAYS, 3)).astype(np.float32)
    d = rs.normal(0, 1, (N_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # every third ray infinite, every third short, every third dead
    tmax = np.where(np.arange(N_RAYS) % 3 == 0, INF,
                    np.where(np.arange(N_RAYS) % 3 == 1, 2.5, -1.0)).astype(np.float32)
    bvh = build_bvh(p0, e1, e2)
    pt = to_device(build_pair_table(p0, e1, e2, bvh), "cpu")
    bl = to_device(build_blocklist(p0, e1, e2, bvh), "cpu")
    jpt = j_build_pair_table(p0, e1, e2, j_build_bvh(p0, e1, e2))
    geo = Geometry(*(torch.from_numpy(a) for a in (p0, e1, e2)), *([None] * 10))
    return dict(pt=pt, bl=bl, jpt=jpt, geo=geo, o=o, d=d, tmax=tmax)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tiles(s, cap=5):
    o, d, tm = _t(s["o"]), _t(s["d"]), _t(s["tmax"])
    ids, _ = build_pair_lists(s["pt"], o, d, tm)
    skeys, spays, _ = sorted_pairs(s["pt"], ids, o.shape[0], cap)
    return pair_tiles(skeys, spays, o, d, tm)


@pytest.mark.parametrize("infinite", [True, False])
def test_pair_lists_are_bit_equal(soup, infinite):
    tmax = np.full(N_RAYS, INF, np.float32) if infinite else soup["tmax"]
    ids, dropped = build_pair_lists(soup["pt"], _t(soup["o"]), _t(soup["d"]), _t(tmax))
    jids, jdropped = jpairs.build_pair_lists(soup["jpt"], jnp.asarray(soup["o"]),
                                             jnp.asarray(soup["d"]), jnp.asarray(tmax))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
    assert (ids.numpy() >= 0).sum() > N_RAYS  # the lists are not trivially empty


@pytest.mark.parametrize("any_hit", [False, True])
def test_mt_tiles_match_the_pallas_kernel(soup, any_hit):
    """Every pair's winner (row 1) and hit set are bit-equal; t differs
    from the interpreted kernel by the FMAs XLA contracts on the CPU
    (a few ulp on about half the hits; the port rounds every step, as the
    CUDA kernel built with -fmad=false does)."""
    pdata, tile_block = _tiles(soup)
    assert (tile_block >= 0).sum() > 10 and (tile_block < 0).sum() > 0
    got = mt_tiles_plain(soup["pt"].tri_rows, tile_block, pdata, any_hit).numpy()
    want = np.asarray(jpairs._mt_tiles_pallas(soup["jpt"].tri_rows, jnp.asarray(tile_block.numpy()),
                                              jnp.asarray(pdata.numpy()), any_hit,
                                              interpret=True))
    np.testing.assert_array_equal(got[1], want[1])
    hit = got[0] < INF
    np.testing.assert_array_equal(hit, want[0] < INF)
    assert hit.sum() > 100
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=4e-6)
    got = torch.from_numpy(got)
    # on a CPU tensor the wrapper is the plain version
    torch.testing.assert_close(mt_tiles(soup["pt"].tri_rows, tile_block, pdata, any_hit), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("any_hit", [False, True])
def test_plk_tiles_match_the_xla_twin(soup, any_hit):
    pdata, tile_block = _tiles(soup)
    got = plk_tiles_plain(soup["pt"].tri_cols, soup["pt"].tri_rows, tile_block, pdata, any_hit)
    po, pd = pdata[0:3], pdata[3:6]
    m = torch.stack([po[1] * pd[2] - po[2] * pd[1], po[2] * pd[0] - po[0] * pd[2],
                     po[0] * pd[1] - po[1] * pd[0]])
    p = pdata.shape[1]
    pd16 = torch.cat([pd, m, po, torch.ones((1, p)), pdata[6:7], torch.zeros((5, p))])
    jt, jp = jpairs._plk_tiles(soup["jpt"].tri_cols, soup["jpt"].tri_rows,
                               jnp.asarray(tile_block.numpy()),
                               jnp.asarray(pd16.T.reshape(-1, 128, 16).numpy()), any_hit)
    jt, jp = np.asarray(jt).reshape(-1), np.asarray(jp).reshape(-1)
    assert (got[1].numpy() == jp).mean() >= 0.999
    hit = (got[0].numpy() < INF) & (jt < INF)
    assert hit.sum() > 100
    # t = num / den with num = n.(v0 - o): its rounding error scales with
    # the scene's extent, not with t, hence the absolute term
    np.testing.assert_allclose(got[0].numpy()[hit], jt[hit], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cap", [None, 2])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("engine", ["mt", "plk"])
def test_pipeline_matches_the_reference(soup, engine, any_hit, cap):
    args = (soup["o"], soup["d"], soup["tmax"])
    got = intersect_pairs_raw(soup["pt"], *map(_t, args), any_hit=any_hit, cap_factor=cap,
                              engine=engine)
    want = jpairs.intersect_pairs_raw(soup["jpt"], *map(jnp.asarray, args), any_hit=any_hit,
                                      use_pallas=False, cap_factor=cap, engine=engine)
    proven, jproven = got[-1].numpy(), np.asarray(want[-1])
    both = proven & jproven
    assert (proven == jproven).mean() >= 0.999 and both.mean() > 0.5
    k = 0 if any_hit else 1  # occlusion, or the prim
    np.testing.assert_array_equal(got[k].numpy()[both], np.asarray(want[k])[both])
    if not any_hit:
        hit = both & got[4].numpy()
        np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit], rtol=1e-6)


@pytest.mark.parametrize("engine", ["mt", "plk"])
def test_full_queries_equal_the_oracle_on_every_ray(soup, engine):
    o, d, tm = _t(soup["o"]), _t(soup["d"]), _t(soup["tmax"])
    geo = soup["geo"]
    h = intersect_pairs_full(soup["pt"], soup["bl"], o, d, tm, cap_factor=5, engine=engine)
    hb = intersect_brute(geo, o, d, tm)
    np.testing.assert_array_equal(h.prim.numpy(), hb.prim.numpy())
    np.testing.assert_array_equal(h.valid.numpy(), hb.valid.numpy())
    np.testing.assert_allclose(h.t.numpy()[hb.valid.numpy()], hb.t.numpy()[hb.valid.numpy()],
                               rtol=1e-6)
    occ = occluded_pairs_full(soup["pt"], soup["bl"], o, d, tm, cap_factor=5, engine=engine)
    np.testing.assert_array_equal(occ.numpy(), occluded_brute(geo, o, d, tm).numpy())


@pytest.mark.parametrize("engine", ["mt", "plk"])
def test_full_queries_retrace_every_unproven_ray(soup, engine):
    """With a pair budget of one pair per ray, more rays stay unproven than
    the reference re-traces (max(4096, N >> 4)); the port re-traces all of
    them, so every ray still equals the oracle."""
    n = 12288
    rs = np.random.default_rng(11)
    o = _t(rs.uniform(-4.5, 4.5, (n, 3)).astype(np.float32))
    d = rs.normal(0, 1, (n, 3)).astype(np.float32)
    d = _t(d / np.linalg.norm(d, axis=1, keepdims=True))
    tm = torch.full((n,), INF)
    proven = intersect_pairs_raw(soup["pt"], o, d, tm, cap_factor=1, engine=engine)[-1]
    assert int((~proven).sum()) > max(4096, n >> 4)
    geo = soup["geo"]
    h = intersect_pairs_full(soup["pt"], soup["bl"], o, d, tm, cap_factor=1, engine=engine)
    np.testing.assert_array_equal(h.prim.numpy(), intersect_brute(geo, o, d, tm).prim.numpy())
    occ = occluded_pairs_full(soup["pt"], soup["bl"], o, d, tm, cap_factor=1, engine=engine)
    np.testing.assert_array_equal(occ.numpy(), occluded_brute(geo, o, d, tm).numpy())
