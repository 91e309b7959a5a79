"""The port's BVH traversal (ops/intersect_bvh.py, accel/traverse.py) and
the routes of ``trace`` that take it or the sorted blocklist, against the
JAX package on the CPU, on door_room(20000) (17510 triangles): the plain
version of the kernel gives JAX's ``intersect_bvh`` hits and occlusion on
camera and random rays; ``trace(accel="bvh")`` gives JAX's; the scene
without pair tables takes the Morton-sorted blocklist and gives the pair
route's radiance; the numpy BVH builder gives JAX's numpy builder's arrays
bit for bit, and its tree's hits are the native tree's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.accel.traverse import intersect_bvh, occluded
from mitsuba_path_guiding_torch.integrators.path import trace
from mitsuba_path_guiding_torch.models.bsdf import types_present
from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_plain
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box, door_room
from mitsuba_path_guiding_tpu.accel import traverse as jtrav
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.scenes import door_room as j_door_room
from torch_port_parity import frac_close, reference_walk_pops, t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its plain versions run
    many mid-sized tensor ops, and with a thread pool in every worker of
    the parallel test runner the CPU's cores are oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRIS = 20000


@pytest.fixture(scope="module")
def scenes():
    return j_build_scene(j_door_room(TRIS)), build_scene(door_room(TRIS), device="cpu")


def _camera(jscene, w, h, seed=0):
    pix = jnp.arange(w * h, dtype=jnp.int32)
    kj = jrng.ray_keys(jrng.base_key(seed), pix, jnp.zeros_like(pix))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o, d, _ = j_generate_rays(jscene.sensor, w, h, pix, u)
    return np.asarray(o), np.asarray(d), kj


def _random(scene, n, seed):
    rs = np.random.default_rng(seed)
    lo, hi = scene.aabb_min.numpy(), scene.aabb_max.numpy()
    o = (lo + (hi - lo) * rs.random((n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:16, 1] = 0.0                      # rays parallel to a slab
    d[:16] /= np.linalg.norm(d[:16], axis=-1, keepdims=True)
    sel = rs.integers(0, 3, n)
    tmax = np.where(sel == 0, 3.0e38, np.where(sel == 1, 4.0 * rs.random(n), -1.0))
    return o, d, tmax.astype(np.float32)


@pytest.mark.parametrize("rays", ["camera", "random"])
def test_bvh_matches_the_reference(scenes, rays):
    """Closest hit: valid and prim equal (ties go to the triangle found
    first in both), t within 4e-6 relative, u and v within 5e-5 on 99.9%
    of hits and 1e-3 on all (XLA contracts multiply-adds on the CPU; a
    grazing triangle's 1/det scales those few ulps); any-hit: occlusion
    equal."""
    jscene, scene = scenes
    if rays == "camera":
        o, d, _ = _camera(jscene, 64, 64)
        tmax = np.full((o.shape[0],), 3.0e38, np.float32)
    else:
        o, d, tmax = _random(scene, 3000, 7)
    build.reset_launches()
    got = intersect_bvh(scene.geo, scene.bvh, t(o), t(d), t(tmax))
    occ = occluded(scene.geo, scene.bvh, t(o), t(d), t(tmax))
    assert sum(build.LAUNCHES.values()) == 0  # the CPU takes the plain version
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)
    want = jtrav.intersect_bvh(jscene.geo, jscene.bvh, jo, jd, jt)
    jocc = np.asarray(jtrav.occluded(jscene.geo, jscene.bvh, jo, jd, jt))
    valid = np.asarray(want.valid)
    assert 0.3 < valid.mean() and 0.1 < jocc.mean()
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(want.prim))
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(want.t)[valid], rtol=4e-6)
    for a, b in ((got.u, want.u), (got.v, want.v)):
        err = np.abs(a.numpy()[valid] - np.asarray(b)[valid])
        assert (err <= 5e-5).mean() >= 0.999 and err.max() <= 1e-3
    np.testing.assert_array_equal(occ.numpy(), jocc)
    np.testing.assert_array_equal(occ.numpy(), valid)  # tmax bounds both queries


def test_bvh_work_counts(scenes):
    """Nodes popped and triangles tested: any-hit does at most the
    closest-hit walk's work, at most 4 triangles a node.  The box test
    compares the entry distance, negative inside a box, with tmax, so a
    ray with tmax -1 still walks the boxes around its origin (as in the
    reference), and hits nothing."""
    _, scene = scenes
    o, d, tmax = (torch.from_numpy(x) for x in _random(scene, 1000, 8))
    _, prim, _, _, closest = bvh_plain(scene.bvh, o, d, tmax)
    *_, anyhit = bvh_plain(scene.bvh, o, d, tmax, any_hit=True)
    assert (anyhit <= closest).all() and (closest[1] <= 4 * closest[0]).all()
    assert (closest[0] >= 1).all() and closest[0].float().mean() > 10
    assert (anyhit.sum(dim=1) < closest.sum(dim=1)).all()
    assert (prim[tmax < 0] == -1).all()


@pytest.mark.parametrize("rays", ["camera", "random"])
def test_box_tests_equal_the_reference_walks_pops(scenes, rays):
    """On a closest-hit walk every pushed node is popped, so the box tests
    of the walk that tests each box at its parent (1 for the root, 2 an
    inner node) equal the nodes the reference's walk pops."""
    jscene, scene = scenes
    if rays == "camera":
        o, d, _ = _camera(jscene, 32, 32)
        tmax = np.full((o.shape[0],), 3.0e38, np.float32)
    else:
        o, d, tmax = _random(scene, 1000, 9)
    g = scene.geo
    rays = (t(o), t(d), t(tmax))
    *_, counts = bvh_plain(scene.bvh, *rays)
    pops = reference_walk_pops(scene.bvh, g.p0, g.e1, g.e2, *rays)
    assert pops.float().mean() > 10
    assert torch.equal(counts[0], pops)


def _trace_inputs(jscene):
    o, d, kj = _camera(jscene, 16, 16)
    return o, d, kj


def test_trace_bvh_route_matches_the_reference(scenes):
    jscene, scene = scenes
    o, d, kj = _trace_inputs(jscene)
    types = types_present(scene.mats)
    Lj, auxj, _ = j_trace(jscene, jnp.asarray(o), jnp.asarray(d), kj, max_depth=5,
                          use_bvh=True, accel="bvh", em_kinds=(0,), mat_types=types)
    Lt, auxt, _ = trace(scene, t(o), t(d), t(kj), max_depth=5, accel="bvh", em_kinds=(0,),
                        mat_types=types)
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0.0
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99


def test_sorted_blocklist_route_matches_the_pair_route(scenes):
    """Without pair tables "auto" takes the blocklist on sorted rays; both
    routes find the nearest triangle, so the radiance agrees."""
    jscene, scene = scenes
    o, d, kj = _trace_inputs(jscene)
    types = types_present(scene.mats)
    kw = dict(max_depth=5, em_kinds=(0,), mat_types=types)
    L_pair, aux_pair, _ = trace(scene, t(o), t(d), t(kj), **kw)
    L_sorted, aux_sorted, _ = trace(scene._replace(pairs=None), t(o), t(d), t(kj), **kw)
    assert L_pair.mean() > 0.0
    assert frac_close(L_sorted.numpy(), L_pair.numpy(), rtol=1e-4) >= 0.99
    assert (aux_sorted.n_bounces == aux_pair.n_bounces).float().mean() >= 0.99


def test_routes_of_a_small_scene():
    """A small scene carries a BVH and no block tables: "bvh" and
    ``use_bvh`` walk it, "twolevel" raises."""
    scene = build_scene(cornell_box(), device="cpu")
    assert scene.bvh is not None and scene.blocks is None
    o = ((scene.aabb_min + scene.aabb_max) / 2).expand(64, 3).contiguous()
    d = torch.nn.functional.normalize(torch.randn((64, 3), generator=torch.Generator()
                                                  .manual_seed(0)), dim=-1)
    keys = torch.randint(0, 2**32, (64, 2), generator=torch.Generator().manual_seed(1))
    kw = dict(max_depth=3, em_kinds=(0,), mat_types=types_present(scene.mats))
    L_bvh, _, _ = trace(scene, o, d, keys, accel="bvh", **kw)
    L_flag, _, _ = trace(scene, o, d, keys, use_bvh=True, **kw)
    L_tiled, _, _ = trace(scene, o, d, keys, **kw)
    assert torch.equal(L_bvh, L_flag) and L_bvh.mean() > 0.0
    assert frac_close(L_bvh.numpy(), L_tiled.numpy(), rtol=1e-4) >= 0.99
    with pytest.raises(ValueError, match="block tables"):
        trace(scene, o, d, keys, accel="twolevel", **kw)


def _mesh(name):
    """(p0, e1, e2) float32 triangles: the Cornell box's, or 500 random
    ones in a 4-unit cube."""
    if name == "cornell":
        g = build_scene(cornell_box(), device="cpu").geo
        return tuple(a.numpy() for a in (g.p0, g.e1, g.e2))
    rs = np.random.default_rng(5)
    p0 = (4.0 * rs.random((500, 3))).astype(np.float32)
    e1, e2 = ((1.5 * (rs.random((500, 3)) - 0.5)).astype(np.float32) for _ in range(2))
    return p0, e1, e2


MESHES = ["cornell", "random500"]
TREE_FIELDS = ("node_min", "node_max", "child0", "child1", "prim_idx")


@pytest.mark.parametrize("mesh", MESHES)
def test_numpy_builder_matches_the_reference(mesh):
    """accel/bvh.py's numpy builder against JAX's build_bvh(...,
    use_native=False): every array bit-equal, the depth equal."""
    from mitsuba_path_guiding_torch.accel.bvh import build_bvh
    from mitsuba_path_guiding_tpu.accel.bvh import build_bvh as j_build_bvh

    tris = _mesh(mesh)
    got = build_bvh(*tris, use_native=False)
    want = j_build_bvh(*tris, use_native=False)
    for f in TREE_FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=f)
    assert got.max_depth == want.max_depth


@pytest.mark.parametrize("mesh", MESHES)
def test_numpy_tree_hits_match_the_native_tree(mesh):
    """Both trees packed and walked by the plain BVH walk on 2000 random
    rays: valid and t bit-equal, hit ids equal but at exact ties; without
    the native library build_bvh builds the numpy tree."""
    from mitsuba_path_guiding_torch.accel import bvh as bvh_mod
    from mitsuba_path_guiding_torch.accel.native import native_available

    tris = _mesh(mesh)
    p0, e1, e2 = (torch.from_numpy(a) for a in tris)
    trees = [bvh_mod.pack_bvh(bvh_mod.to_device(bvh_mod.build_bvh(*tris, use_native=native), "cpu"),
                              p0, e1, e2) for native in (True, False)]
    assert native_available()
    rs = np.random.default_rng(11)
    lo, hi = tris[0].min(axis=0), tris[0].max(axis=0)
    o = t((lo + (hi - lo) * rs.random((2000, 3))).astype(np.float32))
    d = torch.nn.functional.normalize(t(rs.normal(size=(2000, 3)).astype(np.float32)), dim=-1)
    tmax = torch.full((2000,), 3.0e38)
    (tn, pn), (tp, pp) = (bvh_plain(tree, o, d, tmax)[:2] for tree in trees)
    assert (pn >= 0).float().mean() > 0.3
    assert torch.equal(tn.view(torch.int32), tp.view(torch.int32))
    assert torch.equal(pn >= 0, pp >= 0)
    # with t bit-equal, an id that differs is a second triangle at the same
    # t: an exact tie, which a shared edge makes now and then
    assert (pn != pp).float().mean() < 0.01

    saved = bvh_mod.native_available
    bvh_mod.native_available = lambda: False
    try:
        fallback = bvh_mod.build_bvh(*tris)
    finally:
        bvh_mod.native_available = saved
    reference = bvh_mod.build_bvh(*tris, use_native=False)
    for f in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(fallback, f), getattr(reference, f), err_msg=f)
