"""The per-lane arithmetic of the CUDA kernels (csrc/device_math.cuh),
compiled for the host with g++ behind csrc/host_shim.cpp, against the plain
PyTorch versions: threefry-13, the bits-to-unit map, the Pluecker test with
its packed-key winner, the exact Moeller-Trumbore re-evaluation, the
dense Moeller-Trumbore closest hit, the BVH kernel's walk over the
packed tree, the splits of the tiled and the Pluecker pair-tile
kernels (their records, lanes or warps, two-stage tests and merge order),
and the two-level kernel's tile walk (candidates, exact gates, records,
two-stage tests behind a warp's vote, merges).  Skips where g++ is
missing."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.core import rng as trng
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.ops import fused_path as tfused
from mitsuba_path_guiding_torch.ops import intersect_pairs as tpairs
from mitsuba_path_guiding_torch.ops import intersect_twolevel as ttl
from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_plain
from mitsuba_path_guiding_torch.ops.intersect_tiled import (
    closest_plain,
    intersect_tiled,
    pack_triangles,
)
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box, door_room, veach_mis
import torch_port_parity  # noqa: F401  (shares the cores among xdist workers)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "mitsuba_path_guiding_torch", "csrc")
N = 4096


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = str(tmp_path_factory.mktemp("csrc_host") / "libhostshim.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-I", CSRC, "-o", out, os.path.join(CSRC, "host_shim.cpp")], check=True)
    return ctypes.CDLL(out)


def _p(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _u32(rs, n=N):
    return rs.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)


@pytest.fixture(scope="module")
def rays():
    """Cornell tables and N rays: half from inside the box toward random
    directions, half from the camera position toward the box."""
    scene = build_scene(cornell_box(), device="cpu")
    tables = tfused.build_fused_tables(scene)
    rs = np.random.default_rng(4)
    lo, hi = scene.aabb_min.numpy(), scene.aabb_max.numpy()
    o = (lo + (hi - lo) * rs.random((N, 3))).astype(np.float32)
    o[: N // 2] = scene.sensor.to_world.numpy()[:3, 3]
    tgt = (lo + (hi - lo) * rs.random((N, 3))).astype(np.float32)
    d = np.where(np.arange(N)[:, None] < N // 2, tgt - o, rs.standard_normal((N, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmax = np.where(rs.random(N) < 0.5, 3.0e37, 3.0 * rs.random(N)).astype(np.float32)
    return scene, tables, o, d, tmax


def test_threefry13_and_bits_to_unit(lib):
    rs = np.random.default_rng(0)
    k0, k1, x0, x1 = (_u32(rs) for _ in range(4))
    y0, y1 = np.zeros(N, np.uint32), np.zeros(N, np.uint32)
    lib.host_threefry13(_p(k0), _p(k1), _p(x0), _p(x1), _p(y0), _p(y1), ctypes.c_int(N))
    w0, w1 = trng.threefry2x32(*(torch.from_numpy(a.astype(np.int64)) for a in (k0, k1, x0, x1)),
                               rounds=13)
    np.testing.assert_array_equal(y0.astype(np.int64), w0.numpy())
    np.testing.assert_array_equal(y1.astype(np.int64), w1.numpy())
    f = np.zeros(N, np.float32)
    lib.host_bits_to_unit(_p(y0), _p(f), ctypes.c_int(N))
    np.testing.assert_array_equal(f, trng.bits_to_unit(w0).numpy())


@pytest.mark.parametrize("any_hit", [False, True])
def test_plucker_winner(lib, rays, any_hit):
    scene, tables, o, d, tmax = rays
    t_pad = tables.shade_rows.shape[0]
    lo_mask = (1 << max((t_pad - 1).bit_length(), 1)) - 1
    plk = tables.plk_rows.numpy()
    prim = np.zeros(N, np.int32)
    tb = np.zeros(N, np.float32)
    lib.host_plucker_closest(_p(plk), ctypes.c_int(tables.n_tri), ctypes.c_uint32(lo_mask),
                             _p(o), _p(d), _p(tmax), ctypes.c_int(N), ctypes.c_int(int(any_hit)),
                             _p(prim), _p(tb))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    want = tfused._intersect_plain(tables.plk_rows, (ot[:, 0], ot[:, 1], ot[:, 2]),
                                   (dt[:, 0], dt[:, 1], dt[:, 2]), torch.from_numpy(tmax),
                                   tables.n_tri, any_hit)
    if any_hit:
        np.testing.assert_array_equal(prim.astype(bool), want[0].numpy())
        assert 0.05 < want[0].numpy().mean() < 0.95
    else:
        np.testing.assert_array_equal(prim, want[0].numpy())
        assert (prim >= 0).mean() > 0.5


def test_blocklist_merge_key_orders_like_t_block_id(lib):
    """pg_block_key: for t in (EPS_T, 3e38], blocks 0-31 and float-exact
    ids, integer order of the keys is the lexicographic order of (t, block,
    id), the miss key (3e38, 31, largest id) orders after every hit, and
    unpacking gives back the same bits."""
    rs = np.random.default_rng(9)
    pool = np.concatenate([np.float32([1.00001e-4, 1.0, 1.0000001, 3.0e38]),
                           (10.0 ** rs.uniform(-3.9, 38.4, 60)).astype(np.float32)])
    t = np.clip(rs.choice(pool, N), np.float32(1.00001e-4), np.float32(3.0e38)).astype(np.float32)
    block = rs.integers(0, 32, N).astype(np.uint32)
    tid = np.where(rs.random(N) < 0.5, rs.integers(0, 4, N),
                   rs.integers(0, 2**24, N)).astype(np.uint32)
    key = np.zeros(N, np.uint64)
    t_out, b_out, id_out = np.zeros(N, np.float32), np.zeros(N, np.uint32), np.zeros(N, np.uint32)
    lib.host_block_key(_p(t), _p(block), _p(tid), ctypes.c_int(N), _p(key), _p(t_out), _p(b_out),
                       _p(id_out))
    np.testing.assert_array_equal(t_out.view(np.uint32), t.view(np.uint32))
    np.testing.assert_array_equal(b_out, block)
    np.testing.assert_array_equal(id_out, tid)

    lib.host_key_miss.restype = ctypes.c_uint64
    miss = np.uint64(lib.host_key_miss())
    one = (np.float32([3.0e38]), np.uint32([31]), np.uint32([2**27 - 1]))
    m_key, m_t, m_b, m_id = (np.zeros(1, x) for x in (np.uint64, np.float32, np.uint32, np.uint32))
    lib.host_block_key(*(_p(x) for x in one), ctypes.c_int(1), _p(m_key), _p(m_t), _p(m_b),
                       _p(m_id))
    assert m_key[0] == miss and (m_t[0], m_b[0], m_id[0]) == (np.float32(3.0e38), 31, 2**27 - 1)
    assert (key < miss).all()

    keys = np.append(key, miss)
    tup = tuple(np.concatenate([a, b]) for a, b in zip((tid, block, t), one[::-1]))
    order = np.lexsort(tup)   # by t, then block, then id
    ks = keys[order]
    same = np.all([x[order][1:] == x[order][:-1] for x in tup], axis=0)
    assert (ks[1:] >= ks[:-1]).all()
    np.testing.assert_array_equal(ks[1:] == ks[:-1], same)
    assert same.sum() > 10 and (~same).sum() > N // 2


def test_mt_exact_and_dense_closest(lib, rays):
    scene, tables, o, d, tmax = rays
    geo = scene.geo
    tri9 = torch.cat([geo.p0, geo.e1, geo.e2], dim=1).numpy().copy()
    n_tri = tri9.shape[0]
    t = np.zeros(N, np.float32)
    prim = np.zeros(N, np.int32)
    u = np.zeros(N, np.float32)
    v = np.zeros(N, np.float32)
    lib.host_mt_closest(_p(tri9), ctypes.c_int(n_tri), _p(o), _p(d), _p(tmax), ctypes.c_int(N),
                        _p(t), _p(prim), _p(u), _p(v))
    bt, bp, bu, bv, valid = closest_plain(geo.p0, geo.e1, geo.e2, torch.from_numpy(o),
                                          torch.from_numpy(d), torch.from_numpy(tmax))
    np.testing.assert_array_equal(prim, bp.numpy())
    np.testing.assert_array_equal(t, bt.numpy())
    np.testing.assert_array_equal(u[valid.numpy()], bu.numpy()[valid.numpy()])
    np.testing.assert_array_equal(v[valid.numpy()], bv.numpy()[valid.numpy()])

    # the fused kernel's exact re-evaluation of each ray's winner
    sel = np.clip(prim, 0, None)
    tri_w = tri9[sel].copy()
    te, ue, ve = (np.zeros(N, np.float32) for _ in range(3))
    lib.host_mt_exact(_p(tri_w), _p(o), _p(d), ctypes.c_int(N), _p(te), _p(ue), _p(ve))
    tw = torch.from_numpy(tri_w).T
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    wt, wu, wv = tfused._mt_exact(tw, (ot[:, 0], ot[:, 1], ot[:, 2]), (dt[:, 0], dt[:, 1], dt[:, 2]))
    np.testing.assert_array_equal(te, wt.numpy())
    np.testing.assert_array_equal(ue, wu.numpy())
    np.testing.assert_array_equal(ve, wv.numpy())


@pytest.mark.parametrize("any_hit", [False, True])
def test_plucker_two_stages(lib, rays, any_hit):
    """pg_plucker_inside then pg_plucker_depth, the second only where the
    first passed (as the fused kernel skips it), give the plain version's
    winner bit for bit."""
    scene, tables, o, d, tmax = rays
    t_pad = tables.shade_rows.shape[0]
    lo_mask = (1 << max((t_pad - 1).bit_length(), 1)) - 1
    plk = tables.plk_rows.numpy()
    prim = np.zeros(N, np.int32)
    tb = np.zeros(N, np.float32)
    lib.host_plucker_split_closest(_p(plk), ctypes.c_int(tables.n_tri), ctypes.c_uint32(lo_mask),
                                   _p(o), _p(d), _p(tmax), ctypes.c_int(N),
                                   ctypes.c_int(int(any_hit)), _p(prim), _p(tb))
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    want = tfused._intersect_plain(tables.plk_rows, (ot[:, 0], ot[:, 1], ot[:, 2]),
                                   (dt[:, 0], dt[:, 1], dt[:, 2]), torch.from_numpy(tmax),
                                   tables.n_tri, any_hit)
    if any_hit:
        np.testing.assert_array_equal(prim.astype(bool), want[0].numpy())
        assert 0.05 < want[0].numpy().mean() < 0.95
    else:
        np.testing.assert_array_equal(prim, want[0].numpy())
        assert (prim >= 0).mean() > 0.5


def test_mt_two_stages(lib, rays):
    """pg_mt_u then pg_mt_vt, the second only where the first passed (as
    the pair tile kernel skips it): the dense closest hit equals the plain
    version's bit for bit, and no (ray, triangle) that pg_mt_u rules out
    is a hit of pg_mt_test."""
    scene, tables, o, d, tmax = rays
    geo = scene.geo
    tri9 = torch.cat([geo.p0, geo.e1, geo.e2], dim=1).numpy().copy()
    t, u, v = (np.zeros(N, np.float32) for _ in range(3))
    prim = np.zeros(N, np.int32)
    lib.host_mt_split_closest.restype = ctypes.c_int
    wrong = lib.host_mt_split_closest(_p(tri9), ctypes.c_int(tri9.shape[0]), _p(o), _p(d),
                                      _p(tmax), ctypes.c_int(N), _p(t), _p(prim), _p(u), _p(v))
    assert wrong == 0
    bt, bp, bu, bv, valid = closest_plain(geo.p0, geo.e1, geo.e2, torch.from_numpy(o),
                                          torch.from_numpy(d), torch.from_numpy(tmax))
    np.testing.assert_array_equal(prim, bp.numpy())
    np.testing.assert_array_equal(t, bt.numpy())
    np.testing.assert_array_equal(u[valid.numpy()], bu.numpy()[valid.numpy()])
    np.testing.assert_array_equal(v[valid.numpy()], bv.numpy()[valid.numpy()])
    assert valid.numpy().mean() > 0.5


def test_mt_loose_two_stages(lib):
    """The bf16 pair kernel's loose test in its two stages (pg_mt_u_loose,
    then pg_mt_vt_loose) against the whole test on the same t, u, v: equal
    on 2e5 (triangle, ray) pairs of bf16-rounded rays aimed at barycentrics
    in [-0.06, 1.1] (half of them at the corner p0 + e1), so that hits
    fill the slack beyond the triangle's edges, with u up to 1 + 2 s and
    the first stage's u_hi above them."""
    rs = np.random.default_rng(21)
    n = 200_000
    p0 = rs.uniform(-3, 3, (n, 3))
    e1, e2 = rs.normal(0, 0.3, (n, 3)), rs.normal(0, 0.3, (n, 3))
    b = rs.uniform(-0.06, 1.1, (n, 2))
    # half at the corner p0 + e1, where the slack lets u reach 1 + 2 s
    b[: n // 2] = rs.uniform((0.95, -0.04), (1.08, 0.04), (n // 2, 2))
    target = p0 + b[:, :1] * e1 + b[:, 1:] * e2
    o = target + rs.normal(0, 2.0, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri = np.concatenate([p0, e1, e2], axis=1).astype(np.float32)
    o, d = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16).float().numpy()
            for x in (o, d))
    tmax = np.where(rs.random(n) < 0.8, 3.0e37, rs.uniform(0.0, 4.0, n)).astype(np.float32)
    tmax = torch.from_numpy(tmax).to(torch.bfloat16).float().numpy()
    neg, one, eps_lo, u_hi = tpairs.loose_bounds()
    hit = np.zeros(n, np.int32)
    t, u = np.zeros(n, np.float32), np.zeros(n, np.float32)
    lib.host_mt_loose_pairs.restype = ctypes.c_int
    wrong = lib.host_mt_loose_pairs(_p(tri), _p(o), _p(d), _p(tmax), ctypes.c_int(n),
                                    *(ctypes.c_float(x) for x in (neg, one, eps_lo, u_hi)),
                                    _p(hit), _p(t), _p(u))
    assert wrong == 0
    h = hit.astype(bool)
    assert h.mean() > 0.2 and (h & (u > 1.0)).sum() > 1000 and (h & (u < 0.0)).sum() > 1000
    assert u[h].max() > 1.0 + 1.5 * tpairs.BF16_SLACK and u[h].max() < u_hi


@pytest.fixture(scope="module")
def bvh_scenes():
    """door_room(20000) (17510 triangles) and the Cornell box, each with
    camera rays of a 64x32 image and random rays from points of the
    scene's box (a third each with an unbounded, a short and a -1 tmax;
    16 parallel to a slab), and the plain walk's results, computed once."""
    out = {}
    for name, desc in (("door_room", door_room(20000)), ("cornell", cornell_box())):
        scene = build_scene(desc, device="cpu")
        w, h = 64, 32
        pix = torch.arange(w * h)
        keys = trng.ray_keys(trng.base_key(3), pix, torch.zeros_like(pix))
        o_c, d_c, _ = generate_rays(scene.sensor, w, h, pix,
                                    trng.event_uniform(keys, trng.TAG_CAMERA, 2))
        rs = np.random.default_rng(11)
        lo, hi = scene.aabb_min.numpy(), scene.aabb_max.numpy()
        o_r = (lo + (hi - lo) * rs.random((w * h, 3))).astype(np.float32)
        d_r = rs.normal(size=(w * h, 3)).astype(np.float32)
        d_r[:16, 1] = 0.0
        d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
        sel = rs.integers(0, 3, w * h)
        t_r = np.where(sel == 0, 3.0e38, np.where(sel == 1, 4.0 * rs.random(w * h), -1.0))
        sets = {"camera": (o_c.numpy().astype(np.float32), d_c.numpy().astype(np.float32),
                           np.full(w * h, 3.0e38, np.float32)),
                "random": (o_r, d_r, t_r.astype(np.float32))}
        plain = {}
        for label, (o, d, tmax) in sets.items():
            for any_hit in (False, True):
                plain[label, any_hit] = bvh_plain(scene.bvh, torch.from_numpy(o),
                                                  torch.from_numpy(d), torch.from_numpy(tmax),
                                                  any_hit)
        out[name] = (scene, sets, plain)
    return out


@pytest.mark.parametrize("name", ["door_room", "cornell"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("label", ["camera", "random"])
def test_bvh_walk_matches_plain(lib, bvh_scenes, name, any_hit, label):
    """The kernel's walk (pg_bvh_walk over the packed tree) gives bvh_plain's
    t, prim, u, v and both work counts bit for bit."""
    scene, sets, plain = bvh_scenes[name]
    nodes = scene.bvh.packed_nodes.numpy()
    tris = scene.bvh.packed_tris.numpy()
    o, d, tmax = sets[label]
    n = o.shape[0]
    t, u, v = (np.zeros(n, np.float32) for _ in range(3))
    prim = np.zeros(n, np.int32)
    counts = np.zeros((2, n), np.int32)
    lib.host_bvh_walk(_p(nodes), _p(tris), ctypes.c_int(tris.shape[0]), _p(o), _p(d), _p(tmax),
                      ctypes.c_int(n), ctypes.c_int(int(any_hit)), _p(t), _p(prim), _p(u), _p(v),
                      _p(counts))
    wt, wp, wu, wv, wc = (x.numpy() for x in plain[label, any_hit])
    assert (wp >= 0).mean() > (0.3 if label == "camera" else 0.1)
    np.testing.assert_array_equal(prim, wp)
    for a, b in ((t, wt), (u, wu), (v, wv)):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    np.testing.assert_array_equal(counts, wc)


@pytest.fixture(scope="module")
def tiled_sets():
    """The Cornell box and veach_mis (3850 triangles), each with camera
    rays of a 48x32 image and as many random rays from points of the
    scene's box (a third each with an unbounded, a short and a -1 tmax)."""
    out = {}
    for name, desc in (("cornell", cornell_box()), ("veach_mis", veach_mis())):
        scene = build_scene(desc, device="cpu")
        w, h = 48, 32
        pix = torch.arange(w * h)
        keys = trng.ray_keys(trng.base_key(5), pix, torch.zeros_like(pix))
        o_c, d_c, _ = generate_rays(scene.sensor, w, h, pix,
                                    trng.event_uniform(keys, trng.TAG_CAMERA, 2))
        rs = np.random.default_rng(12)
        lo, hi = scene.aabb_min.numpy(), scene.aabb_max.numpy()
        o_r = (lo + (hi - lo) * rs.random((w * h, 3))).astype(np.float32)
        d_r = rs.normal(size=(w * h, 3)).astype(np.float32)
        d_r /= np.linalg.norm(d_r, axis=-1, keepdims=True)
        sel = rs.integers(0, 3, w * h)
        t_r = np.where(sel == 0, 3.0e37, np.where(sel == 1, 4.0 * rs.random(w * h), -1.0))
        o = np.concatenate([o_c.numpy(), o_r]).astype(np.float32)
        d = np.concatenate([d_c.numpy(), d_r]).astype(np.float32)
        tmax = np.concatenate([np.full(w * h, 3.0e38), t_r]).astype(np.float32)
        out[name] = (scene, o, d, tmax)
    return out


@pytest.mark.parametrize("name,n_tri", [("cornell", 36), ("veach_mis", 1), ("veach_mis", 127),
                                        ("veach_mis", 128), ("veach_mis", 129),
                                        ("veach_mis", 3850)])
@pytest.mark.parametrize("any_hit", [False, True])
def test_tiled_lanes_match_plain(lib, tiled_sets, name, n_tri, any_hit):
    """intersect_tiled.cu's split (records, four lanes a ray, two-stage
    tests, the butterfly merge by pg_nearer) gives intersect_tiled's plain
    version's t, prim, u, v bits on every lane (u = v = 0 on a miss), and
    its occlusion."""
    scene, o, d, tmax = tiled_sets[name]
    g = scene.geo
    pack = pack_triangles(g.p0[:n_tri], g.e1[:n_tri], g.e2[:n_tri]).numpy()
    n = o.shape[0]
    t, u, v = (np.zeros(n, np.float32) for _ in range(3))
    prim = np.zeros(n, np.int32)
    hit = np.zeros(n, np.uint8)
    lib.host_tiled_lanes(_p(pack), ctypes.c_int(pack.shape[1]), ctypes.c_int(n_tri), _p(o),
                         _p(d), _p(tmax), ctypes.c_int(n), ctypes.c_int(int(any_hit)), _p(t),
                         _p(prim), _p(u), _p(v), _p(hit))
    want = intersect_tiled(torch.from_numpy(pack), torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tmax), n_tri, any_hit)
    if any_hit:
        np.testing.assert_array_equal(hit.astype(bool), want.numpy())
        return
    wt, wp, wu, wv, valid = (x.numpy() for x in want)
    np.testing.assert_array_equal(prim, wp)
    for a, b in ((t, wt), (u, wu), (v, wv)):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert (u[~valid] == 0).all() and (v[~valid] == 0).all()
    if n_tri in (36, 3850):
        assert 0.2 < valid.mean() < 0.9


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("label", ["camera", "random"])
def test_plk_tiles_match_plain(lib, bvh_scenes, any_hit, label):
    """intersect_pairs.cu's Pluecker tiles (records from tri_cols, four
    warps' shares, two-stage tests, the merge by pg_nearer) give
    plk_tiles_plain's bits on every pair of door_room(20000)'s sorted pairs,
    with every fifth pair killed (tmax 0, -1 or EPS_T) so that slots are
    partly dead."""
    scene, sets, _ = bvh_scenes["door_room"]
    o, d, tmax = (torch.from_numpy(x) for x in sets[label])
    ids, _ = tpairs.build_pair_lists(scene.pairs, o, d, tmax)
    skeys, spays, _ = tpairs.sorted_pairs(scene.pairs, ids, o.shape[0], 5)
    pdata, tile_block = tpairs.pair_tiles(skeys, spays, o, d, tmax)
    k = torch.arange(pdata.shape[1])
    pdata[6] = torch.where(k % 5 == 0, torch.tensor([0.0, -1.0, 1e-4])[k % 3], pdata[6])
    cols, rows = scene.pairs.tri_cols, scene.pairs.tri_rows
    want = tpairs.plk_tiles_plain(cols, rows, tile_block, pdata, any_hit).numpy()
    got = np.zeros_like(want)
    pd, tb = pdata.contiguous().numpy(), tile_block.numpy()
    lib.host_plk_tiles(_p(cols.contiguous().numpy()), _p(rows.contiguous().numpy()),
                       ctypes.c_int(cols.shape[0]), _p(tb), ctypes.c_int(tb.shape[0]), _p(pd),
                       ctypes.c_int(int(any_hit)), _p(got))
    assert (tb < 0).any() and (want[0] < tpairs.INF).sum() > 100
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _tl_soup(seed, tris, n, tmax, spread=4.0, size=0.3):
    """Triangles and rays as tests/test_torch_twolevel.py makes them."""
    rs = np.random.default_rng(seed)
    p0 = (rs.random((tris, 3)).astype(np.float32) - 0.5) * spread
    e1 = (rs.random((tris, 3)).astype(np.float32) - 0.5) * size
    e2 = (rs.random((tris, 3)).astype(np.float32) - 0.5) * size
    o = (rs.random((n, 3)).astype(np.float32) - 0.5) * 6
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return p0, e1, e2, o, d, np.full((n,), tmax, np.float32)


def _tl_wall(seed, n):
    """A wall of two triangles at x = -1, first in Morton order, and 3000
    small triangles behind it: rays from x = -5 along +x make every box
    behind the wall a candidate on entering the superblock, and the wall's
    hits close them all."""
    rs = np.random.default_rng(seed)
    p0 = np.concatenate([[[-1, -3, -3], [-1, 3, 3]], rs.uniform([2, -2, -2], [4, 2, 2], (3000, 3))])
    e1 = np.concatenate([[[0, 6, 0], [0, -6, 0]], rs.uniform(-0.2, 0.2, (3000, 3))])
    e2 = np.concatenate([[[0, 0, 6], [0, 0, -6]], rs.uniform(-0.2, 0.2, (3000, 3))])
    o = np.stack([np.full(n, -5.0), rs.uniform(-1, 1, n), rs.uniform(-1, 1, n)], axis=1)
    d = np.stack([np.ones(n), rs.uniform(-0.1, 0.1, n), rs.uniform(-0.1, 0.1, n)], axis=1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (*(x.astype(np.float32) for x in (p0, e1, e2, o, d)), np.full((n,), 3.0e38, np.float32))


TWOLEVEL_SETS = {
    # tests/test_torch_twolevel.py CASES: (seed, triangles, rays, tmax)
    "closest": lambda: _tl_soup(1, 2500, 700, 3.0e38),
    "tmax": lambda: _tl_soup(2, 1200, 300, 1.5),
    # three superblocks, a ragged last tile (1000 rays) and a short tmax
    "ragged": lambda: _tl_soup(7, 20000, 1000, 0.3),
    # candidates that do not open
    "wall": lambda: _tl_wall(3, 1024),
}


@pytest.mark.parametrize("case", sorted(TWOLEVEL_SETS))
def test_twolevel_tile_walk_matches_plain(lib, case):
    """intersect_twolevel.cu's walk (host_twolevel_tile: the candidate
    pass, the exact gates, the records, the two-stage tests behind each
    warp's vote, the merges) gives twolevel_plain's t, prim, u and v bits
    and its four work counts on every tile."""
    p0, e1, e2, o, d, tmax = TWOLEVEL_SETS[case]()
    bt = ttl.build_blocks(p0, e1, e2)
    ot, dt, tt = (torch.from_numpy(x) for x in (o, d, tmax))
    ray, tmax_p = ttl._pad_rays(ot, dt, tt)
    mask, order = ttl.superblock_mask(bt, ot, dt, tt)
    want, wwork = ttl.twolevel_plain(bt, ray, tmax_p, mask, order)
    npad = ray.shape[1]
    nt = npad // ttl.RAY_TILE
    args = [np.ascontiguousarray(x.numpy()) for x in (mask, order, bt.blk_lo, bt.blk_hi, ray,
                                                      tmax_p, bt.tri_pack)]
    out = np.zeros((4, npad), np.float32)
    work = np.zeros((nt, 4), np.int64)
    stats = np.zeros(5, np.int64)
    for tile in range(nt):
        lib.host_twolevel_tile(_p(args[0]), _p(args[1]), ctypes.c_int(args[1].shape[0]),
                               _p(args[2]), _p(args[3]), ctypes.c_int(args[2].shape[1]),
                               _p(args[4]), _p(args[5]), ctypes.c_int(npad), _p(args[6]),
                               ctypes.c_int(tile), _p(out), _p(work), _p(stats))
    np.testing.assert_array_equal(out.view(np.int32), want.numpy().view(np.int32))
    np.testing.assert_array_equal(work, wwork.numpy())
    assert (want[1] >= 0).sum() >= 9
    assert stats[0] > stats[1] and stats[2] > stats[3] >= stats[4] > 0
    if case == "wall":
        assert stats[1] >= 40      # the boxes behind the wall, in both tiles


def _surely_out(lib, num, det, tri=None, o=None, d=None):
    num, det = np.ascontiguousarray(num, np.float32), np.ascontiguousarray(det, np.float32)
    reject, may = np.zeros(num.size, np.uint8), np.zeros(num.size, np.uint8)
    counts = np.zeros(5, np.int64)
    n_tri, n_rays = (0, 0) if tri is None else (tri.shape[0], o.shape[0])
    lib.host_mt_surely_out(_p(num), _p(det), ctypes.c_int(num.size), _p(reject), _p(may),
                           None if tri is None else _p(tri), ctypes.c_int(n_tri),
                           None if o is None else _p(o), None if d is None else _p(d),
                           ctypes.c_int(n_rays), _p(counts))
    return reject.astype(bool), may.astype(bool), counts


def test_mt_surely_out_is_conservative(lib):
    """pg_mt_surely_out, the two-level kernel's division-free reject, holds
    only where pg_mt_u_of fails: on edge cases of (num, det) (|det| at
    1e-12, num +-0, u exactly 0 and 1, products that underflow to +-0,
    subnormals, infinities, NaN), on 10^6 random (num, det) pairs of every
    magnitude, and on 10^6 ray-triangle pairs through pg_mt_num, which with
    pg_mt_u_of gives pg_mt_u's bits."""
    f = np.float32
    e12 = f(1e-12)
    dets = np.array([e12, np.nextafter(e12, f(0)), np.nextafter(e12, f(1)), 1.0, 3.0, 0.75,
                     1e-6, 1e6, 1e30, 3.0e38, 2.0**126, 2.0**-126, 1e-45, 0.0, np.inf, np.nan],
                    np.float32)
    dets = np.concatenate([dets, -dets])
    ratios = np.array([0.0, 1.0, 1 + 2.0**-23, 1 - 2.0**-24, 1 + 2.0**-11, 1 + 2.0**-10,
                       1 + 2.0**-9, 0.5, 2.0, 2.0**-64, 2.0**-65, 2.0**-140, 1e-60, 1e-40,
                       1e20, 1e40])
    ratios = np.concatenate([ratios, -ratios])
    with np.errstate(all="ignore"):
        by_ratio = (dets[:, None].astype(np.float64) * ratios[None, :]).astype(np.float32)
    nums = np.concatenate([by_ratio.ravel(), [0.0, -0.0, 1e-45, -1e-45, 1e-30, -1e-30, 1.0,
                                              -1.0, 3e38, -3e38, np.inf, -np.inf, np.nan]])
    num = np.concatenate([by_ratio.ravel(), np.repeat(nums[None, :], dets.size, 0).ravel()])
    det = np.concatenate([np.repeat(dets, ratios.size),
                          np.repeat(dets[:, None], nums.size, 1).ravel()])
    reject, may, _ = _surely_out(lib, num, det)
    assert not (reject & may).any(), list(zip(num[reject & may][:5], det[reject & may][:5]))
    # the cases the proof turns on are present, on both sides
    edge = {"u exactly 0": (num == 0) & (np.abs(det) >= e12) & np.isfinite(det),
            "u exactly 1": (num == det) & (np.abs(det) >= e12) & np.isfinite(det),
            "underflow to -0": (num == f(-1e-30)) & (det == f(1e30))}
    for what, sel in edge.items():
        assert may[sel].all() and not reject[sel].any(), what
    assert reject.sum() > 100 and (~reject & ~may).sum() > 100

    rs = np.random.default_rng(21)
    mag = lambda n: 10.0 ** rs.uniform(-46, 38.5, n) * rs.choice([-1.0, 1.0], n)  # noqa: E731
    with np.errstate(all="ignore"):
        num, det = mag(10**6).astype(np.float32), mag(10**6).astype(np.float32)
        close = rs.random(10**6) < 0.5       # half with u near 1 or -1
        num[close] = (det[close] * rs.choice([-1.0, 1.0], close.sum())
                      * (1 + rs.normal(0, 1e-3, close.sum()))).astype(np.float32)
    reject, may, _ = _surely_out(lib, num, det)
    assert not (reject & may).any()
    assert reject.mean() > 0.5 and may.sum() > 10**4

    p0, e1, e2, o, d, _ = _tl_soup(8, 1000, 1000, 3.0e38)
    tri = np.ascontiguousarray(np.concatenate([p0, e1, e2], axis=1), np.float32)
    _, _, counts = _surely_out(lib, np.zeros(0), np.zeros(0), tri, o, d)
    assert counts[0] == 10**6 and counts[3] == 0 and counts[4] == 0
    assert counts[1] > 0.5 * counts[0] and counts[2] > 1000
