"""The port's blocklist intersector (ops/intersect_blocklist.py) against the
JAX package's on the CPU: on the soups of tests/test_blocklist.py, the
plain version of the kernel gives the Pallas kernel's t, prim, u and v
(interpret mode), closest-hit, any-hit, with tmax, and on a soup of more
superblocks than the list width (the walk-everything overflow path); its
work counts equal the Pallas kernel's debug counters, and its count of
needed triangle tests equals one made from each ray's own box gate.  Each
superblock step of the plain version is one reduction over all of its
visits, so two more cases probe that order: equal t within a block and
across blocks of one step, and incoherent bounce rays of door_room(20000)."""
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
import torch_port_parity  # noqa: F401  (shares the cores among xdist workers)


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


def _own_gate_tests(bl, o, d, tmax):
    """Per tile, the needed triangle tests of a closest-hit walk over one
    superblock: per block, the rays whose own slab test (with their tmax)
    passes its box and whose tmax exceeds EPS_T, times its real triangles."""
    box = bl.blk_box[0].numpy()                                     # (32, 8)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, np.float32(1e-12), d)
    t0 = (box[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (box[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    lo, hi = np.minimum(t0, t1), np.maximum(t0, t1)
    tn = np.maximum(np.maximum(lo[..., 0], lo[..., 1]), np.maximum(lo[..., 2], 0.0))
    tf = np.minimum(np.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
    gate = (tf >= tn) & (tn <= tmax[:, None]) & (tmax[:, None] > 1e-4)   # (n, 32)
    real = (bl.tri_pack[0, :, 9, :].numpy() >= 0).sum(axis=1)           # (32,)
    want = np.zeros((o.shape[0] + 255) // 256, np.int64)
    np.add.at(want, np.arange(o.shape[0]) // 256, gate @ real)
    return want


def _tie_case():
    """600 random triangles and three of them copied 300 times each, one
    superblock.  Half the rays aim at the copied triangles' centroids: the
    copies of one triangle fill more than one block, so such a ray meets
    equal t within a block and across blocks of one superblock step."""
    rs, p0, e1, _ = _soup(16, 600)
    # right isosceles triangles (legs 0.2): no slivers, whose 1/det would
    # scale the few ulp of XLA's contracted sums past the tolerances
    e1 /= np.linalg.norm(e1, axis=-1, keepdims=True)
    e2 = np.cross(e1, rs.normal(size=(600, 3)).astype(np.float32))
    e2 /= np.linalg.norm(e2, axis=-1, keepdims=True)
    e1, e2 = e1 * np.float32(0.2), e2 * np.float32(0.2)
    idx = np.concatenate([np.arange(600), np.repeat(np.arange(3), 300)])
    p0, e1, e2 = p0[idx], e1[idx], e2[idx]
    n = 640
    o, d = _rays(rs, n)
    aim = p0[:3] + (e1[:3] + e2[:3]) / np.float32(3.0)
    tgt = aim[np.arange(n // 2) % 3] - o[: n // 2]
    d[: n // 2] = tgt / np.linalg.norm(tgt, axis=-1, keepdims=True)
    return p0, e1, e2, o, d


def _incoherent_case(door_tris):
    """A few hundred rays leaving random points of door_room(20000)'s
    triangles in uniform random directions, offset 1e-4 along the normal
    to the side they leave on: the blocklist fallback's input."""
    p0, e1, e2 = door_tris
    rs = np.random.default_rng(12)
    n = 400
    tri = rs.integers(0, p0.shape[0], n)
    u, v = rs.random(n).astype(np.float32), rs.random(n).astype(np.float32)
    flip = u + v > 1.0
    u, v = np.where(flip, 1.0 - u, u), np.where(flip, 1.0 - v, v)
    p = p0[tri] + u[:, None] * e1[tri] + v[:, None] * e2[tri]
    nrm = np.cross(e1[tri], e2[tri])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (p + np.sign((d * nrm).sum(-1, keepdims=True)) * nrm * np.float32(1e-4)).astype(np.float32)
    return p0, e1, e2, o, d


@pytest.fixture(scope="module")
def door_tris():
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    geo = build_scene(door_room(20000), device="cpu").geo
    return tuple(x.numpy() for x in (geo.p0, geo.e1, geo.e2))


@pytest.mark.parametrize("case", ["ties", "incoherent"])
def test_step_reduction_matches_the_pallas_kernel(monkeypatch, door_tris, case):
    """Each superblock step of the plain version is one reduction over all
    of its visits; on equal t within and across blocks, and on incoherent
    bounce rays, closest hit, any-hit and the work counts still equal the
    Pallas kernel's (interpret mode)."""
    p0, e1, e2, o, d = _tie_case() if case == "ties" else _incoherent_case(door_tris)
    bl, jbl = _tables(p0, e1, e2)
    n = o.shape[0]
    if case == "ties":
        assert bl.sb_lo.shape[0] == 1
        ids = bl.tri_pack[0, :, 9, :].numpy()                           # (32, 128)
        src = np.where(ids < 600, ids, (ids - 600) // 300)    # the triangle each slot copies
        copies = [((src == c) & (ids >= 0)).sum(axis=1) for c in range(3)]
        assert max((c > 0).sum() for c in copies) >= 2            # across blocks
        assert max(c.max() for c in copies) >= 2                  # within a block
    tmax = np.full((n,), 3.0e38, np.float32)
    got = intersect_blocklist_raw(bl, *(torch.from_numpy(x) for x in (o, d, tmax)))
    want = jblk.intersect_blocklist_raw(jbl, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                                        interpret=True)
    valid = np.asarray(want[4])
    assert valid.sum() >= n // 4
    np.testing.assert_array_equal(got[4].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the tolerances of test_closest_hit_matches_the_pallas_kernel
    np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid], rtol=1e-5)
    for a, b in ((got[2], want[2]), (got[3], want[3])):
        np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid], rtol=0, atol=5e-5)
    if case == "ties":
        # the winner of a tie is the least block, then the least id in it:
        # some ray's winner is a copy other than the first one
        assert (got[1].numpy() >= 600).any()

    t_any = np.where(np.arange(n) % 2 == 0, 3.0e38, 0.5).astype(np.float32)
    occ = occluded_blocklist_raw(bl, *(torch.from_numpy(x) for x in (o, d, t_any)))
    occ_want = np.asarray(jblk.occluded_blocklist_raw(jbl, jnp.asarray(o), jnp.asarray(d),
                                                      jnp.asarray(t_any), interpret=True))
    assert 0.05 < occ_want.mean() < 0.95
    np.testing.assert_array_equal(occ.numpy(), occ_want)

    monkeypatch.setattr(jblk, "DEBUG_COUNTERS", True)
    for any_hit, tm in ((False, tmax), (True, t_any)):
        out, work = blocklist_run(bl, *(torch.from_numpy(x) for x in (o, d, tm)), any_hit=any_hit)
        o_p, d_p, t_p, _ = jblk._pad_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tm))
        w = np.asarray(jblk._run_kernel(jbl, o_p, d_p, t_p, interpret=True, any_hit=any_hit))
        np.testing.assert_array_equal(out[1].numpy(), w[1])
        np.testing.assert_array_equal(work.numpy()[:, 0], w[4, ::256].astype(np.int32))
        np.testing.assert_array_equal(work.numpy()[:, 1], w[5, ::256].astype(np.int32))
        if case == "ties" and not any_hit:
            np.testing.assert_array_equal(work.numpy()[:, 2], _own_gate_tests(bl, o, d, tm))


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
    want = _own_gate_tests(bl, o, d, tmax)
    np.testing.assert_array_equal(work.numpy()[:, 2], want)
    assert want.sum() > 0
