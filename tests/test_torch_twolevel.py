"""The port's two-level superblock intersector (ops/intersect_twolevel.py)
and the Morton-sorted routes against the JAX package on the CPU: the
block tables bit-equal, the superblock mask bit-equal and its order equal
up to near-equal mean distances, the ray sort keys of both sorted routes
bit-equal, and the plain version of the kernel giving the Pallas
kernel's hits (interpret mode) on the soups of tests/test_twolevel.py.
JAX's sorted wrappers call their Pallas kernels compiled for the TPU, so
the sorted routes are held to JAX's steps composed here: keys, stable
argsort, the kernel in interpret mode, the inverse scatter."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
from mitsuba_path_guiding_torch.accel.bvh import build_bvh, to_device
from mitsuba_path_guiding_torch.convert import block_table_from_numpy
from mitsuba_path_guiding_torch.ops import intersect_blocklist as tblk
from mitsuba_path_guiding_torch.ops import intersect_twolevel as ttl
from mitsuba_path_guiding_torch.ops.intersect_tiled import closest_plain
from mitsuba_path_guiding_tpu.accel.blocks import build_blocklist as j_build_blocklist
from mitsuba_path_guiding_tpu.accel.bvh import build_bvh as j_build_bvh
from mitsuba_path_guiding_tpu.ops import intersect_blocklist as jblk
from mitsuba_path_guiding_tpu.ops import intersect_twolevel as jtl
from torch_port_parity import to_numpy_tree



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its plain versions run
    many mid-sized tensor ops, and with a thread pool in every worker of
    the parallel test runner the CPU's cores are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _j(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("tris", [2500, 20000])
def test_block_tables_are_bit_equal(tris):
    _, p0, e1, e2 = _soup(1, tris)
    got, want = ttl.build_blocks(p0, e1, e2), jtl.build_blocks(p0, e1, e2)
    assert got.tri_pack.shape[0] == (tris + ttl.SB_TRIS - 1) // ttl.SB_TRIS
    conv = block_table_from_numpy(to_numpy_tree(want), device="cpu")
    for f in ttl.BlockTable._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                      err_msg=f)
        assert torch.equal(getattr(conv, f), getattr(got, f)), f


def _j_mean_tn(bt, o, d, tmax):
    """The reference's stage-A mean entry distances, in float64."""
    lo, hi = np.asarray(bt.sb_lo, np.float64), np.asarray(bt.sb_hi, np.float64)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d).astype(np.float64)
    t0 = (lo[:, None, :] - o[None]) * inv[None]
    t1 = (hi[:, None, :] - o[None]) * inv[None]
    tn = np.maximum(np.minimum(t0, t1).max(axis=-1), 0.0)
    tf = np.maximum(t0, t1).min(axis=-1)
    hit = (tf >= tn) & (tn <= tmax[None])
    cnt = hit.sum(axis=1)
    return np.where(cnt > 0, np.where(hit, tn, 0.0).sum(axis=1) / np.maximum(cnt, 1), 3.0e38)


def test_superblock_mask_and_order():
    rs, p0, e1, e2 = _soup(3, 40000, spread=8.0, size=0.15)
    bt, jbt = ttl.build_blocks(p0, e1, e2), jtl.build_blocks(p0, e1, e2)
    o, d = _rays(rs, 1300, spread=10.0)
    o = o[np.argsort(o[:, 0])]           # tiles of nearby origins
    tmax = np.where(np.arange(1300) >= 1024, 3.0e38, 0.8).astype(np.float32)
    mask, order = ttl.superblock_mask(bt, *_t(o, d, tmax))
    jmask, jorder = jtl.superblock_mask(jbt, *_j(o, d, tmax))
    assert mask.shape == (3, 5) and 0 < int(mask.sum()) < mask.numel()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    # the means are float sums in another order: where the orders differ,
    # the means they swap agree to float32 rounding
    mean = _j_mean_tn(jbt, o, d, tmax)
    jorder = np.asarray(jorder)
    np.testing.assert_allclose(mean[order.numpy()], mean[jorder], rtol=1e-5)
    assert sorted(order.tolist()) == list(range(5))


def test_ray_sort_keys_are_bit_equal():
    rs, p0, e1, e2 = _soup(4, 20000)
    o, d = _rays(rs, 4000)
    d[:7, 2] = 0.0                       # direction components of both signs of zero
    d[7:14, 0] = -0.0
    bt, jbt = ttl.build_blocks(p0, e1, e2), jtl.build_blocks(p0, e1, e2)
    np.testing.assert_array_equal(ttl._ray_sort_keys(bt, *_t(o, d)).numpy(),
                                  np.asarray(jtl._ray_sort_keys(jbt, *_j(o, d))))
    bl = to_device(build_blocklist(p0, e1, e2, build_bvh(p0, e1, e2)), "cpu")
    jbl = j_build_blocklist(p0, e1, e2, j_build_bvh(p0, e1, e2))
    np.testing.assert_array_equal(tblk._ray_sort_keys(bl, *_t(o, d)).numpy(),
                                  np.asarray(jblk._ray_sort_keys(jbl, *_j(o, d))))


CASES = {
    # name: (seed, triangles, rays, tmax) as in tests/test_twolevel.py
    "closest": (1, 2500, 700, 3.0e38),
    "tmax": (2, 1200, 300, 1.5),
}


def _assert_hits_close(got, want):
    """valid and prim equal; t within 4e-6 relative and u, v within 5e-5
    (XLA contracts multiply-adds on the CPU, the port rounds each step)."""
    valid = np.asarray(want[4])
    assert valid.sum() >= 5
    np.testing.assert_array_equal(got[4].numpy(), valid)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy()[valid], np.asarray(want[0])[valid], rtol=4e-6)
    for a, b in ((got[2], want[2]), (got[3], want[3])):
        np.testing.assert_allclose(a.numpy()[valid], np.asarray(b)[valid], rtol=0, atol=5e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_the_pallas_kernel(case):
    seed, tris, n, tm = CASES[case]
    rs = np.random.default_rng(seed)
    p0 = (rs.random((tris, 3)).astype(np.float32) - 0.5) * 4.0
    e1 = (rs.random((tris, 3)).astype(np.float32) - 0.5) * 0.3
    e2 = (rs.random((tris, 3)).astype(np.float32) - 0.5) * 0.3
    o = (rs.random((n, 3)).astype(np.float32) - 0.5) * 6
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full((n,), tm, np.float32)
    got = ttl.intersect_blocks(ttl.build_blocks(p0, e1, e2), *_t(o, d, tmax))
    want = jtl.intersect_blocks(jtl.build_blocks(p0, e1, e2), *_j(o, d, tmax), interpret=True)
    _assert_hits_close(got, want)
    if tm < 3.0e38:
        assert (got[0][got[4]] <= tm).all()


def test_mask_is_conservative_and_needed_tests_are_a_subset():
    """Every ray's true hit lies in a superblock its tile's mask flags,
    and the tests the data needed are at most the tests run."""
    rs, p0, e1, e2 = _soup(5, 20000, spread=6.0, size=0.2)
    bt = ttl.build_blocks(p0, e1, e2)
    o, d = _rays(rs, 1024, spread=8.0)
    tmax = np.full((1024,), 3.0e38, np.float32)
    mask, _ = ttl.superblock_mask(bt, *_t(o, d, tmax))
    ref = closest_plain(*_t(p0, e1, e2, o, d, tmax))
    slot = np.zeros(len(p0), np.int64)
    ids = bt.tri_pack[:, 9, :].reshape(-1).numpy()
    slot[ids[ids >= 0].astype(np.int64)] = np.nonzero(ids >= 0)[0]
    rays = np.nonzero(ref[4].numpy())[0]
    assert len(rays) > 100
    sb = slot[ref[1].numpy()[rays]] // ttl.SB_TRIS
    assert (mask.numpy()[rays // ttl.RAY_TILE, sb] == 1).all()
    out, work = ttl.twolevel_run(bt, *_t(o, d, tmax))
    np.testing.assert_array_equal(out[1, :1024].to(torch.int32).numpy(), ref[1].numpy())
    w = work.numpy()
    np.testing.assert_array_equal(w[:, 0], mask.sum(dim=1).numpy())
    np.testing.assert_array_equal(w[:, 2], w[:, 1] * ttl.RAY_TILE * ttl.TRI_TILE)
    assert (0 < w[:, 3]).all() and (w[:, 3] <= w[:, 2]).all()


def _j_sorted(keys, raw, o, d, tmax):
    """JAX's sorted wrapper with the kernel call ``raw`` in interpret mode."""
    n = o.shape[0]
    perm = jnp.argsort(keys)
    out = raw(o[perm], d[perm], tmax[perm])
    inv = jnp.zeros((n,), jnp.int32).at[perm].set(jnp.arange(n, dtype=jnp.int32))
    return tuple(x[inv] for x in out) if isinstance(out, tuple) else out[inv]


def test_blocks_sorted_matches_the_reference_steps():
    rs, p0, e1, e2 = _soup(1, 2500)
    o, d = _rays(rs, 700)
    tmax = np.where(np.arange(700) % 2 == 0, 3.0e38, 1.5).astype(np.float32)
    bt, jbt = ttl.build_blocks(p0, e1, e2), jtl.build_blocks(p0, e1, e2)
    got = ttl.intersect_blocks_sorted(bt, *_t(o, d, tmax))
    jo, jd, jt = _j(o, d, tmax)
    want = _j_sorted(jtl._ray_sort_keys(jbt, jo, jd),
                     lambda a, b, c: jtl.intersect_blocks(jbt, a, b, c, interpret=True), jo, jd, jt)
    _assert_hits_close(got, want)


@pytest.mark.parametrize("any_hit", [False, True])
def test_blocklist_sorted_matches_the_reference_steps(any_hit):
    rs, p0, e1, e2 = _soup(6, 3000)
    o, d = _rays(rs, 600)
    tmax = np.where(np.arange(600) % 2 == 0, 3.0e38, 1.0).astype(np.float32)
    bl = to_device(build_blocklist(p0, e1, e2, build_bvh(p0, e1, e2)), "cpu")
    jbl = j_build_blocklist(p0, e1, e2, j_build_bvh(p0, e1, e2))
    jo, jd, jt = _j(o, d, tmax)
    keys = jblk._ray_sort_keys(jbl, jo, jd)
    if any_hit:
        got = tblk.occluded_blocklist_sorted(bl, *_t(o, d, tmax))
        want = np.asarray(_j_sorted(keys, lambda a, b, c: jblk.occluded_blocklist_raw(
            jbl, a, b, c, interpret=True), jo, jd, jt))
        assert 0.01 < want.mean() < 0.99
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        got = tblk.intersect_blocklist_sorted(bl, *_t(o, d, tmax))
        want = _j_sorted(keys, lambda a, b, c: jblk.intersect_blocklist_raw(
            jbl, a, b, c, interpret=True), jo, jd, jt)
        _assert_hits_close(got, want)
