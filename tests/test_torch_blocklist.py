"""The port's blocklist intersector (ops/intersect_blocklist.py) against the
JAX package's on the CPU: on the soups of tests/test_blocklist.py, the
plain version of the kernel gives the Pallas kernel's t, prim, u and v
(interpret mode), closest-hit, any-hit, with tmax, and on a soup of more
superblocks than the list width (the walk-everything overflow path); its
work counts equal the Pallas kernel's debug counters, and its count of
needed triangle tests equals one made from each ray's own box gate."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
from mitsuba_path_guiding_torch.accel.bvh import build_bvh, to_device
from mitsuba_path_guiding_torch.ops.intersect_blocklist import (
    _pad_rays,
    blocklist_run,
    candidate_superblocks,
    cand_width,
    intersect_blocklist_raw,
    occluded_blocklist_raw,
)
from mitsuba_path_guiding_tpu.accel.blocks import build_blocklist as j_build_blocklist
from mitsuba_path_guiding_tpu.accel.bvh import build_bvh as j_build_bvh
from mitsuba_path_guiding_tpu.ops import intersect_blocklist as jblk


def _soup(seed, t, spread=4.0, size=0.3):
    rs = np.random.default_rng(seed)
    p0 = (rs.random((t, 3)).astype(np.float32) - 0.5) * spread
    e1 = (rs.random((t, 3)).astype(np.float32) - 0.5) * size
    e2 = (rs.random((t, 3)).astype(np.float32) - 0.5) * size
    return rs, p0, e1, e2


def _rays(rs, n, spread=6.0):
    o = (rs.random((n, 3)).astype(np.float32) - 0.5) * spread
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _tables(p0, e1, e2):
    bl = to_device(build_blocklist(p0, e1, e2, build_bvh(p0, e1, e2)), "cpu")
    return bl, j_build_blocklist(p0, e1, e2, j_build_bvh(p0, e1, e2))


CASES = {
    # name: (seed, triangles, rays, tmax, k, size)
    "closest": (1, 2500, 700, 3.0e38, 128, 0.3),
    "tmax": (2, 1200, 300, 1.5, 128, 0.3),
    "overflow": (4, 30000, 512, 3.0e38, 1, 0.15),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_closest_hit_matches_the_pallas_kernel(case):
    seed, tris, n, tm, k, size = CASES[case]
    rs, p0, e1, e2 = _soup(seed, tris, spread=8.0 if case == "overflow" else 4.0, size=size)
    bl, jbl = _tables(p0, e1, e2)
    o, d = _rays(rs, n, spread=10.0 if case == "overflow" else 6.0)
    tmax = np.full((n,), tm, np.float32)
    got = intersect_blocklist_raw(bl, torch.from_numpy(o), torch.from_numpy(d),
                                  torch.from_numpy(tmax), k=k)
    want = jblk.intersect_blocklist_raw(jbl, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                                        interpret=True, k=k)
    valid = np.asarray(want[4])
    assert valid.sum() >= 5
    np.testing.assert_array_equal(got[4].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # XLA contracts multiply-adds on the CPU: a few ulp of t; the
    # barycentrics u, v in [0, 1] scale those by 1/det, which small
    # triangles make large (up to ~1e-5 here)
    np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid], rtol=1e-5)
    for a, b in ((got[2], want[2]), (got[3], want[3])):
        np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid], rtol=0, atol=5e-5)
    if case == "overflow":
        o_p, d_p, t_p, npad = _pad_rays(*(torch.from_numpy(x) for x in (o, d, tmax)))
        s = bl.sb_lo.shape[0]
        _, cnt = candidate_superblocks(bl.sb_lo, bl.sb_hi, o_p, d_p, t_p, cand_width(npad, s, k))
        assert s > 8 and (cnt > cand_width(npad, s, k)).all()


@pytest.mark.parametrize("tm", [3.0e38, 1.0])
def test_any_hit_matches_the_pallas_kernel(tm):
    rs, p0, e1, e2 = _soup(6, 1500)
    bl, jbl = _tables(p0, e1, e2)
    o, d = _rays(rs, 400)
    tmax = np.full((400,), tm, np.float32)
    got = occluded_blocklist_raw(bl, torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(tmax))
    want = np.asarray(jblk.occluded_blocklist_raw(jbl, jnp.asarray(o), jnp.asarray(d),
                                                  jnp.asarray(tmax), interpret=True))
    assert 0.01 < want.mean() < 0.99
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("any_hit", [False, True])
def test_work_counts_equal_the_reference_debug_counters(monkeypatch, any_hit):
    rs, p0, e1, e2 = _soup(5, 3000)
    bl, jbl = _tables(p0, e1, e2)
    o, d = _rays(rs, 512)
    tmax = np.where(np.arange(512) % 2 == 0, 3.0e38, 0.8).astype(np.float32)
    out, work = blocklist_run(bl, torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(tmax), any_hit=any_hit)
    monkeypatch.setattr(jblk, "DEBUG_COUNTERS", True)
    o_p, d_p, t_p, _ = jblk._pad_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    want = np.asarray(jblk._run_kernel(jbl, o_p, d_p, t_p, interpret=True, any_hit=any_hit))
    np.testing.assert_array_equal(out[1].numpy(), want[1])
    np.testing.assert_array_equal(work.numpy()[:, 0], want[4, ::256].astype(np.int32))
    np.testing.assert_array_equal(work.numpy()[:, 1], want[5, ::256].astype(np.int32))
    assert work.numpy()[:, 1].sum() > 0


def test_needed_triangle_tests_count_each_rays_own_gate():
    """One superblock (3000 triangles, 24 blocks), closest hit: every gate
    is taken with the ray's tmax, so the needed tests are, per block, the
    rays whose own slab test passes its box and whose tmax exceeds EPS_T,
    times the block's real triangles."""
    rs, p0, e1, e2 = _soup(8, 3000)
    bl, _ = _tables(p0, e1, e2)
    assert bl.sb_lo.shape[0] == 1
    n = 1000
    o, d = _rays(rs, n)
    tmax = np.where(np.arange(n) % 3 == 0, 3.0e38,
                    np.where(np.arange(n) % 3 == 1, 1.0, -1.0)).astype(np.float32)
    _, work = blocklist_run(bl, *(torch.from_numpy(x) for x in (o, d, tmax)))
    box = bl.blk_box[0].numpy()                                     # (32, 8)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, np.float32(1e-12), d)
    t0 = (box[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (box[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
    tn = np.maximum(np.maximum(lo[..., 0], lo[..., 1]), np.maximum(lo[..., 2], 0.0))
    tf = np.minimum(np.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    gate = (tf >= tn) & (tn <= tmax[:, None]) & (tmax[:, None] > 1e-4)   # (n, 32)
    real = (bl.tri_pack[0, :, 9, :].numpy() >= 0).sum(axis=1)           # (32,)
    want = np.zeros(work.shape[0], np.int64)
    np.add.at(want, np.arange(n) // 256, gate @ real)
    np.testing.assert_array_equal(work.numpy()[:, 2], want)
    assert want.sum() > 0
