"""The pair route's configurations against the JAX package on the CPU: the
candidate-list widths (ksb, l_blk), bf16 pair data in the MT tiles
(PAIR_DATA_BF16, BF16_SLACK), the reference's fallback cap (fb_shift) and
its selection, and trace's camera peel (PAIR_PEEL, CAM_PAIR_CFG) and
blocklist shadows (SHADOW_BLOCKLIST).  The 3000-triangle soup and its rays
are tests/test_torch_pairs.py's; door_room(20000) is built as
tests/test_torch_door_room.py builds it.  Both packages read their knobs at
call time (JAX at trace time, hence ``jax.clear_caches()`` around a run)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.accel import traverse
from mitsuba_path_guiding_torch.accel.traverse import (
    intersect_brute,
    intersect_pairs_full,
    occluded_brute,
    occluded_pairs_full,
)
from mitsuba_path_guiding_torch.integrators import path as tpath
from mitsuba_path_guiding_torch.models.bsdf import types_present
from mitsuba_path_guiding_torch.ops.intersect_blocklist import intersect_blocklist_raw
from mitsuba_path_guiding_torch.ops import intersect_pairs as tpairs
from mitsuba_path_guiding_tpu.accel import traverse as jtraverse
from mitsuba_path_guiding_tpu.accel.blocks import build_blocklist as j_build_blocklist
from mitsuba_path_guiding_tpu.accel.bvh import build_bvh as j_build_bvh
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.integrators import path as jpath
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.ops.intersect_pairs import intersect_pairs_raw as j_pairs_raw
from mitsuba_path_guiding_tpu.ops import intersect_blocklist as jblk
from mitsuba_path_guiding_tpu.ops import intersect_pairs as jpairs
from test_torch_door_room import MISS_ORIGIN, full_door_room  # noqa: F401  (door_room())
from test_torch_door_room import scenes  # noqa: F401  (door_room(20000), both packages)
from test_torch_pairs import N_RAYS, _t, soup  # noqa: F401  (the 3000-triangle soup)
from torch_port_parity import frac_close, t

INF = 3.0e38
WIDTHS = [(8, 8), (12, 12), (5, 5), (4, 4)]


def _args(s):
    return s["o"], s["d"], s["tmax"]


@pytest.mark.parametrize("ksb,l_blk", WIDTHS)
def test_pair_lists_at_each_width_are_bit_equal(soup, ksb, l_blk):
    ids, dropped = tpairs.build_pair_lists(soup["pt"], *map(_t, _args(soup)), ksb=ksb,
                                           l_blk=l_blk)
    jids, jdropped = jpairs.build_pair_lists(soup["jpt"], *map(jnp.asarray, _args(soup)),
                                             ksb=ksb, l_blk=l_blk)
    assert ids.shape == (l_blk, N_RAYS)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("ksb,l_blk", WIDTHS)
def test_pipeline_at_each_width_matches_the_reference(soup, ksb, l_blk, any_hit):
    """As tests/test_torch_pairs.py::test_pipeline_matches_the_reference,
    at the route's compaction budget (5)."""
    got = tpairs.intersect_pairs_raw(soup["pt"], *map(_t, _args(soup)), ksb=ksb, l_blk=l_blk,
                                     any_hit=any_hit, cap_factor=5)
    want = jpairs.intersect_pairs_raw(soup["jpt"], *map(jnp.asarray, _args(soup)), ksb=ksb,
                                      l_blk=l_blk, any_hit=any_hit, use_pallas=False,
                                      cap_factor=5)
    proven, jproven = got[-1].numpy(), np.asarray(want[-1])
    both = proven & jproven
    assert (proven == jproven).mean() >= 0.999 and both.mean() > 0.5
    k = 0 if any_hit else 1  # occlusion, or the prim
    np.testing.assert_array_equal(got[k].numpy()[both], np.asarray(want[k])[both])
    if not any_hit:
        hit = both & got[4].numpy()
        np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit], rtol=1e-6)


# Camera rays of door_room() at 512x512 (seed 0, sample 0; the origin is
# tests/test_torch_door_room.py's MISS_ORIGIN) that the pair route proves
# with the floor (prim 29) where the dense oracle finds the dividing wall's
# base (prim 12), by list width, as float32 bits of the direction
# (chip_smoke phase 23 counts them among its 8192 camera rays).  The wall's
# block is a dropped candidate, and the proof compares the hit and the
# dropped entry as keys truncated to their top 16 bits with <=: a hit in
# the dropped entry's bucket (1/128 of its value) passes as proven.
WIDTH_MISSES = {
    (8, 8): {201098: (3196194156, 3198133219, 1063936656)},
    (5, 5): {201616: (3195677593, 3198167405, 1063975074),
             201617: (3195543946, 3198144802, 1063987772)},
    (4, 4): {201618: (3195462115, 3198134164, 1063994959),
             201620: (3195183919, 3198145984, 1064011034),
             202133: (3195055932, 3198188133, 1064012077),
             202134: (3194909903, 3198199591, 1064019406),
             202653: (3194081140, 3198202811, 1064069799),
             203165: (3194148159, 3198228790, 1064061367),
             204724: (3191424256, 3198300881, 1064196904),
             204726: (3191216912, 3198275619, 1064211176)},
}


@pytest.mark.parametrize("width", list(WIDTH_MISSES))
def test_width_misses_are_the_references(full_door_room, width):
    """At each width the rays the pair route gets wrong on the card are
    proven with the same triangle by the JAX package, the hit shares its
    truncated key with the dropped entry, and the blocklist finds the
    wall."""
    scene, jpt = full_door_room
    ksb, l_blk = width
    bits = np.array([MISS_ORIGIN + dbits for dbits in WIDTH_MISSES[width].values()], np.uint32)
    o, d = bits[:, 0:3].view(np.float32), bits[:, 3:6].view(np.float32)
    tmax = np.full((len(bits),), 3.0e37, np.float32)
    kw = dict(ksb=ksb, l_blk=l_blk, cap_factor=tpath.PAIR_CAP)
    got = tpairs.intersect_pairs_raw(scene.pairs, t(o), t(d), t(tmax), **kw)
    want = j_pairs_raw(jpt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), use_pallas=False,
                       **kw)
    assert got[5].all() and np.asarray(want[5]).all()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    oracle = intersect_brute(scene.geo, t(o), t(d), t(tmax))
    assert (got[1] == 29).all() and (oracle.prim == 12).all() and (oracle.t < got[0]).all()
    _, dropped = tpairs.build_pair_lists(scene.pairs, t(o), t(d), t(tmax), ksb=ksb, l_blk=l_blk)
    assert torch.equal(got[0].view(torch.int32) & -65536, dropped & -65536)
    assert (intersect_blocklist_raw(scene.blocks, t(o), t(d), t(tmax))[1] == 12).all()


def _bf16_tiles(s):
    o, d, tm = map(_t, _args(s))
    ids, _ = tpairs.build_pair_lists(s["pt"], o, d, tm)
    skeys, spays, _ = tpairs.sorted_pairs(s["pt"], ids, o.shape[0], 5)
    pdata, tile_block = tpairs.pair_tiles(skeys, spays, o, d, tm, bf16=True)
    p32, _ = tpairs.pair_tiles(skeys, spays, o, d, tm)
    return pdata, p32, tile_block


def test_bf16_tiles_match_the_pallas_kernel(soup):
    """The bf16 pair rows are the reference's rounding of the f32 rows, and
    the plain version's loose test gives the interpreted Pallas kernel's
    winners (row 1) and hit set, t within the f32 test's tolerance (XLA
    contracts multiply-adds on the CPU)."""
    pdata, p32, tile_block = _bf16_tiles(soup)
    assert pdata.dtype == torch.bfloat16
    jrows = jnp.asarray(p32.numpy()).astype(jnp.bfloat16)
    np.testing.assert_array_equal(pdata.float().numpy(), np.asarray(jrows.astype(jnp.float32)))
    s = jpairs.BF16_SLACK
    assert tpairs.loose_bounds()[:3] == tuple(float(jnp.asarray(x, jnp.float32)) for x in (
        -s, 1.0 + s, jpairs.EPS_T * (1.0 - s)))
    got = tpairs.mt_tiles_plain(soup["pt"].tri_rows, tile_block, pdata, False).numpy()
    want = np.asarray(jpairs._mt_tiles_pallas(soup["jpt"].tri_rows,
                                              jnp.asarray(tile_block.numpy()), jrows, False,
                                              interpret=True))
    np.testing.assert_array_equal(got[1], want[1])
    hit = got[0] < INF
    np.testing.assert_array_equal(hit, want[0] < INF)
    assert hit.sum() > 100
    np.testing.assert_allclose(got[0][hit], want[0][hit], rtol=4e-6)
    # the slack admits pairs the f32 test rejects
    strict = tpairs.mt_tiles_plain(soup["pt"].tri_rows, tile_block, p32, False).numpy()
    assert hit.sum() > (strict[0] < INF).sum()
    with pytest.raises(ValueError, match="closest hits only"):
        tpairs.mt_tiles(soup["pt"].tri_rows, tile_block, pdata, True)


@pytest.fixture
def bf16_both():
    """PAIR_DATA_BF16 on in both packages, the JAX tile kernel in interpret
    mode, and JAX's traces dropped before and after."""
    saved = (tpairs.PAIR_DATA_BF16, jpairs.PAIR_DATA_BF16, jpairs._mt_tiles_pallas)
    tpairs.PAIR_DATA_BF16 = jpairs.PAIR_DATA_BF16 = True
    jpairs._mt_tiles_pallas = partial(saved[2], interpret=True)
    jax.clear_caches()
    yield
    tpairs.PAIR_DATA_BF16, jpairs.PAIR_DATA_BF16, jpairs._mt_tiles_pallas = saved
    jax.clear_caches()


def test_bf16_pipeline_matches_the_reference(soup, bf16_both):
    """The whole bf16 closest-hit pipeline against the reference's with its
    Pallas kernel (interpret mode); slack-admitted impostors are unproven
    in both."""
    got = tpairs.intersect_pairs_raw(soup["pt"], *map(_t, _args(soup)), cap_factor=5)
    want = jpairs.intersect_pairs_raw(soup["jpt"], *map(jnp.asarray, _args(soup)),
                                      use_pallas=True, cap_factor=5)
    proven, jproven = got[-1].numpy(), np.asarray(want[-1])
    both = proven & jproven
    assert (proven == jproven).mean() >= 0.999 and both.mean() > 0.5
    np.testing.assert_array_equal(got[1].numpy()[both], np.asarray(want[1])[both])
    hit = both & got[4].numpy()
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(want[0])[hit], rtol=1e-6)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


@pytest.mark.parametrize("query", [("mt", True), ("plk", False), ("plk", True)])
def test_bf16_leaves_any_hit_and_pluecker_in_f32(soup, query, monkeypatch):
    engine, any_hit = query
    args = (soup["pt"], *map(_t, _args(soup)))
    kw = dict(any_hit=any_hit, cap_factor=5, engine=engine)
    monkeypatch.setattr(tpairs, "PAIR_DATA_BF16", True)
    on = tpairs.intersect_pairs_raw(*args, **kw)
    monkeypatch.setattr(tpairs, "PAIR_DATA_BF16", False)
    off = tpairs.intersect_pairs_raw(*args, **kw)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,share,shift", [(12288, 0.4, 4), (12288, 0.01, 4), (70000, 0.3, 4),
                                           (3000, 0.0, 4), (3000, 1.0, 4), (700, 0.5, 1)])
def test_unproven_selection_is_bit_equal(n, share, shift):
    proven = np.random.default_rng(n + int(share * 100)).random(n) >= share
    cap = jtraverse._fallback_cap(n, shift)
    assert traverse._fallback_cap(n, shift) == cap
    got = traverse._unproven_idx(torch.from_numpy(proven), cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtraverse._unproven_idx(
        jnp.asarray(proven), cap)))


@pytest.fixture(scope="module")
def capped_rays():
    """tests/test_torch_pairs.py::test_full_queries_retrace_every_unproven_ray's
    12288 rays, with a pair budget of one pair a ray."""
    n = 12288
    rs = np.random.default_rng(11)
    o = rs.uniform(-4.5, 4.5, (n, 3)).astype(np.float32)
    d = rs.normal(0, 1, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, np.full((n,), INF, np.float32)


@pytest.mark.parametrize("engine", ["mt", "plk"])
def test_capped_fallback_equals_the_reference(soup, capped_rays, engine):
    """fb_shift=4 re-traces the reference's first max(4096, N >> 4)
    unproven rays and no other: ray for ray the JAX package's
    intersect_pairs_full(fb_shift=4) and occluded_pairs_full, rays beyond
    the cap left with a wrong hit as the reference leaves them."""
    geo = soup["geo"]
    jbl = j_build_blocklist(*(x.numpy() for x in (geo.p0, geo.e1, geo.e2)),
                            j_build_bvh(*(x.numpy() for x in (geo.p0, geo.e1, geo.e2))))
    o, d, tm = map(_t, capped_rays)
    jo, jd, jt = map(jnp.asarray, capped_rays)
    kw = dict(fb_shift=4, cap_factor=1, engine=engine)
    h = intersect_pairs_full(soup["pt"], soup["bl"], o, d, tm, **kw)
    jh = jtraverse.intersect_pairs_full(soup["jpt"], jbl, jo, jd, jt, **kw)
    np.testing.assert_array_equal(h.prim.numpy(), np.asarray(jh.prim))
    np.testing.assert_array_equal(h.valid.numpy(), np.asarray(jh.valid))
    # XLA contracts multiply-adds on the CPU, and t = (e2 . qv) / det
    # cancels: an error that scales with the scene's extent, not with t
    np.testing.assert_allclose(h.t.numpy()[h.valid.numpy()], np.asarray(jh.t)[h.valid.numpy()],
                               rtol=1e-5, atol=1e-5)
    occ = occluded_pairs_full(soup["pt"], soup["bl"], o, d, tm, **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jtraverse.occluded_pairs_full(
        soup["jpt"], jbl, jo, jd, jt, **kw)))
    # the cap leaks: some rays keep a wrong hit (every ray is right with
    # fb_shift None, tests/test_torch_pairs.py)
    assert int((h.prim != intersect_brute(geo, o, d, tm).prim).sum()) > 0
    assert int((occ != occluded_brute(geo, o, d, tm)).sum()) > 0


CONFIGS = {"peel": ("PAIR_PEEL",), "shadow_blocklist": ("SHADOW_BLOCKLIST",)}


@pytest.fixture
def config_both(request):
    """One of trace's pair-route knobs on in both packages; JAX's any-hit
    blocklist kernel in interpret mode (its sorted wrapper calls the Pallas
    kernel compiled), JAX's traces dropped before and after."""
    names = CONFIGS[request.param]
    saved = [(m, k, getattr(m, k)) for m in (tpath, jpath) for k in names]
    saved.append((jblk, "occluded_blocklist_raw", jblk.occluded_blocklist_raw))
    for m, k, _ in saved[:-1]:
        setattr(m, k, True)
    jblk.occluded_blocklist_raw = partial(saved[-1][2], interpret=True)
    jax.clear_caches()
    yield request.param
    for m, k, v in saved:
        setattr(m, k, v)
    jax.clear_caches()


@pytest.mark.parametrize("config_both", list(CONFIGS), indirect=True)
def test_trace_with_a_pair_config_matches_the_reference(scenes, config_both, monkeypatch):
    """door_room(20000) through trace as
    tests/test_torch_door_room.py::test_trace_matches_the_reference_twolevel_route,
    with the camera peel or blocklist shadows on in both packages; the
    port's queries took the configured widths and routes."""
    jscene, scene = scenes
    pix = jnp.arange(256, dtype=jnp.int32)
    kj = jrng.ray_keys(jrng.base_key(0), pix, jnp.zeros_like(pix))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o, d, _ = j_generate_rays(jscene.sensor, 16, 16, pix, u)
    types = types_present(scene.mats)
    calls = []
    real_full, real_occ = tpath.intersect_pairs_full, tpath.occluded_pairs_full
    real_tl = tpath.occluded_twolevel
    monkeypatch.setattr(tpath, "intersect_pairs_full", lambda *a, **kw: (
        calls.append(("closest", kw["ksb"], kw["l_blk"], kw["fb_shift"])), real_full(*a, **kw))[1])
    monkeypatch.setattr(tpath, "occluded_pairs_full", lambda *a, **kw: (
        calls.append(("pairs_shadow",)), real_occ(*a, **kw))[1])
    monkeypatch.setattr(tpath, "occluded_twolevel", lambda *a: (
        calls.append(("blocklist_shadow",)), real_tl(*a))[1])
    Lj, auxj, _ = jpath.trace(jscene, o, d, kj, max_depth=5, accel="twolevel", em_kinds=(0,),
                              mat_types=types)
    Lt, auxt, _ = tpath.trace(scene, t(o), t(d), t(kj), max_depth=5, em_kinds=(0,),
                              mat_types=types)
    closest = [c[1:] for c in calls if c[0] == "closest"]
    shadows = [c[0] for c in calls if c[0] != "closest"]
    assert len(closest) == 5 and len(shadows) == 5
    if config_both == "peel":
        assert closest == [(12, 12, None)] + [(8, 8, None)] * 4
        assert shadows == ["pairs_shadow"] * 5
    else:
        assert closest == [(8, 8, None)] * 5
        assert shadows == ["blocklist_shadow"] * 5
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0.0
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99
