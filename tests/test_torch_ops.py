"""Plain versions of the port's gather_rows_t and intersect_tiled kernels
against the JAX package's Pallas kernels, run in interpret mode on the
CPU (ops/gather_pallas.py, ops/intersect_pallas.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.accel.traverse import (
    intersect_brute,
    intersect_pallas,
    occluded_brute,
    occluded_pallas,
)
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t, gather_rows_t_plain
from mitsuba_path_guiding_torch.ops.intersect_tiled import pack_triangles
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box
from mitsuba_path_guiding_tpu.accel import traverse as jtraverse
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.ops import gather_pallas as jgather
from mitsuba_path_guiding_tpu.ops import intersect_pallas as jintersect
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.scenes import cornell_box as j_cornell_box
import torch_port_parity  # noqa: F401  (shares the cores among xdist workers)


@pytest.mark.parametrize("r,c,n", [(36, 32, 4096), (512, 32, 1000), (5, 7, 300)])
def test_gather_rows_t_bit_equal(r, c, n):
    rs = np.random.default_rng(r)
    table = rs.standard_normal((r, c)).astype(np.float32)
    idx = rs.integers(-4, r + 4, n).astype(np.int32)   # out of range too
    want_xla = np.asarray(jgather.gather_rows_t(jnp.asarray(table), jnp.asarray(idx)))
    want_pallas = np.asarray(jgather._gather_rows_t_impl(
        jnp.asarray(table), jnp.asarray(idx), interpret=True))
    for ix in (torch.from_numpy(idx), torch.from_numpy(idx).long()):
        got = gather_rows_t(torch.from_numpy(table), ix)
        assert got.shape == (c, n) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want_xla)
        np.testing.assert_array_equal(got.numpy(), want_pallas)
        np.testing.assert_array_equal(gather_rows_t_plain(torch.from_numpy(table), ix).numpy(),
                                      want_xla)


@pytest.fixture(scope="module")
def cornell_rays():
    """1024 Cornell camera rays and 1024 random rays inside the box, each
    with mixed tmax: unbounded, short, and negative (dead lanes)."""
    jscene = j_build_scene(j_cornell_box())
    scene = build_scene(cornell_box(), device="cpu")
    n = 1024
    pix = np.arange(n, dtype=np.int32) * 61 % (256 * 256)
    kj = jrng.ray_keys(jrng.base_key(0), jnp.asarray(pix), jnp.zeros((n,), jnp.int32))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o_cam, d_cam, _ = j_generate_rays(jscene.sensor, 256, 256, jnp.asarray(pix), u)
    rs = np.random.default_rng(5)
    lo, hi = np.asarray(jscene.aabb_min), np.asarray(jscene.aabb_max)
    o_rnd = (lo + (hi - lo) * rs.random((n, 3))).astype(np.float32)
    d_rnd = rs.standard_normal((n, 3)).astype(np.float32)
    d_rnd /= np.linalg.norm(d_rnd, axis=-1, keepdims=True)
    o = np.concatenate([np.asarray(o_cam), o_rnd]).astype(np.float32)
    d = np.concatenate([np.asarray(d_cam), d_rnd]).astype(np.float32)
    sel = rs.integers(0, 3, 2 * n)
    tmax = np.where(sel == 0, 3.0e37, np.where(sel == 1, 4.0 * rs.random(2 * n), -1.0))
    return jscene, scene, o, d, tmax.astype(np.float32)


def _jax_tiled(jscene, o, d, tmax):
    pack = jintersect.pack_triangles(np.asarray(jscene.geo.p0), np.asarray(jscene.geo.e1),
                                     np.asarray(jscene.geo.e2))
    return [np.asarray(x) for x in jintersect.intersect_tiled(
        pack, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), interpret=True)]


def test_pack_triangles_layout(cornell_rays):
    jscene, scene, *_ = cornell_rays
    want = np.asarray(jintersect.pack_triangles(np.asarray(jscene.geo.p0),
                                                np.asarray(jscene.geo.e1),
                                                np.asarray(jscene.geo.e2)))
    got = pack_triangles(scene.geo.p0, scene.geo.e1, scene.geo.e2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["brute", "pallas"])
def test_closest_hit_matches_pallas_interpret(cornell_rays, route):
    jscene, scene, o, d, tmax = cornell_rays
    t_j, prim_j, u_j, v_j, valid_j = _jax_tiled(jscene, o, d, tmax)
    fn = intersect_brute if route == "brute" else intersect_pallas
    hit = fn(scene.geo, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
    prim = hit.prim.numpy()
    assert hit.prim.dtype == torch.int32
    assert (prim == prim_j).mean() >= 0.999
    assert (tmax < 0).any() and not hit.valid.numpy()[tmax < 0].any()
    both = (prim == prim_j) & valid_j
    assert both.sum() > 500
    np.testing.assert_allclose(hit.t.numpy()[both], t_j[both], rtol=1e-5)
    np.testing.assert_allclose(hit.u.numpy()[both], u_j[both], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(hit.v.numpy()[both], v_j[both], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(hit.valid.numpy(), prim >= 0)


def test_tiled_miss_lanes_match_pallas_interpret(cornell_rays):
    """Every lane, hit or miss: the port's tiled intersector on the CPU
    gives the Pallas kernel's valid, and on a miss its t = INF, prim = -1
    and u = v = 0 (closest_plain, JAX's intersect_brute's twin, keeps
    triangle 0's u and v there).  Hits keep the tolerances of
    test_closest_hit_matches_pallas_interpret."""
    jscene, scene, o, d, tmax = cornell_rays
    t_j, prim_j, u_j, v_j, valid_j = _jax_tiled(jscene, o, d, tmax)
    hit = intersect_pallas(scene.geo, torch.from_numpy(o), torch.from_numpy(d),
                           torch.from_numpy(tmax))
    t, prim, u, v, valid = (x.numpy() for x in hit)
    np.testing.assert_array_equal(valid, valid_j)
    miss = ~valid
    assert miss.sum() > 1000
    for got, want in ((t, t_j), (prim, prim_j), (u, u_j), (v, v_j)):
        np.testing.assert_array_equal(got[miss], want[miss])
    assert (u[miss] == 0).all() and (v[miss] == 0).all()
    both = (prim == prim_j) & valid
    np.testing.assert_allclose(u[both], u_j[both], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(v[both], v_j[both], rtol=1e-5, atol=1e-6)


def test_closest_hit_matches_jax_brute(cornell_rays):
    jscene, scene, o, d, tmax = cornell_rays
    ref = jtraverse.intersect_brute(jscene.geo, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    hit = intersect_brute(scene.geo, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_array_equal(hit.t.numpy(), np.asarray(ref.t))


@pytest.mark.parametrize("route", ["brute", "pallas"])
def test_any_hit_matches(cornell_rays, route):
    jscene, scene, o, d, tmax = cornell_rays
    _, _, _, _, valid_j = _jax_tiled(jscene, o, d, tmax)
    occ_j = np.asarray(jtraverse.occluded_brute(jscene.geo, jnp.asarray(o), jnp.asarray(d),
                                                jnp.asarray(tmax)))
    fn = occluded_brute if route == "brute" else occluded_pallas
    occ = fn(scene.geo, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)).numpy()
    assert occ.dtype == np.bool_
    np.testing.assert_array_equal(occ, occ_j)
    assert (occ == valid_j).mean() >= 0.999
