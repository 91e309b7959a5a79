"""The port's specular manifold walks (``integrators/manifold.py``) against
the JAX package on the CPU.

``_onb``, ``_constraint`` and ``fresnel_transmittance`` within 1e-6 on the
same inputs; chip_smoke's ``wavy_surface`` equal to tests/test_manifold.py's
geometry, field by field; the walk on the wavy surface (the port's tiled
route against the reference's dense oracle, the same starting hits):
converged masks equal on >= 99% of the lanes and z within 1e-4 where both
converged (Newton amplifies float32 rounding: the reference contracts
a * b + c into fused multiply-adds on the CPU, the port does not);
``generalized_geometry`` within 1e-3 relative on those lanes.  The JAX
tests' bars on the port: > 95% converged with Snell's law at the
solution, the flat mirror's image-method density within 1%, the density
within a 5% median of finite differences; the manifold-NEE twin (80000
brute-force rays a point) is ``slow``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas, tri_pack_rows
from mitsuba_path_guiding_torch.convert import geometry_from_numpy
from mitsuba_path_guiding_torch.integrators import manifold as M
from mitsuba_path_guiding_tpu.accel.traverse import intersect_brute
from mitsuba_path_guiding_tpu.integrators import manifold as JM
from test_manifold import ETA_WATER, _surface_geo
from torch_port_parity import t, to_numpy_tree

TOL = 1e-6


def _port_geo(**kw):
    return geometry_from_numpy(chip_smoke.wavy_surface(**kw), device="cpu")


def _isect(geo):
    pack = tri_pack_rows(geo)
    return lambda o, d: intersect_pallas(geo, o, d, pack=pack)


def _start(x, y):
    d0 = y - x
    return (d0 / np.linalg.norm(d0, axis=-1, keepdims=True)).astype(np.float32)


def test_wavy_surface_equals_the_jax_tests():
    for kw in ({}, {"amp": 0.04}, {"amp": 0.0}, {"amp": 0.04, "res": 40}):
        want = to_numpy_tree(_surface_geo(**kw))
        got = chip_smoke.wavy_surface(**kw)
        for f, a in got.items():
            np.testing.assert_array_equal(np.asarray(a, np.float32)
                                          if a.dtype.kind == "f" else a, want[f], err_msg=f)


def test_helpers_match_jax():
    gen = np.random.default_rng(7)
    n = gen.standard_normal((4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    for a, b in zip(M._onb(t(n)), JM._onb(jnp.asarray(n))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    ci = gen.uniform(-1, 1, 4096).astype(np.float32)
    for eta in (ETA_WATER, 1.0 / ETA_WATER, 1.5):
        np.testing.assert_allclose(M.fresnel_transmittance(t(ci), eta).numpy(),
                                   np.asarray(JM.fresnel_transmittance(jnp.asarray(ci), eta)),
                                   rtol=0, atol=TOL)
    geo, jgeo = _port_geo(), _surface_geo()
    m = 1024
    prim = gen.integers(0, geo.p0.shape[0], m).astype(np.int32)
    u = gen.uniform(0, 0.5, m).astype(np.float32)
    v = gen.uniform(0, 0.5, m).astype(np.float32)
    x, y = chip_smoke.manifold_points(m, 0, 1.5, 0.4)
    ex, ey = np.full(m, ETA_WATER, np.float32), np.ones(m, np.float32)
    got = M._constraint(geo, t(prim), t(u), t(v), t(x), t(y), t(ex), t(ey))
    want = JM._constraint(jgeo, *(jnp.asarray(a) for a in (prim, u, v, x, y, ex, ey)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def walks():
    """The port's and the reference's walks on test_walk_converges_wavy's
    256 connections, from the reference's starting hits."""
    geo, jgeo = _port_geo(), _surface_geo()
    x, y = chip_smoke.manifold_points(256, 0, 1.5, 0.4)
    h0 = intersect_brute(jgeo, jnp.asarray(x), jnp.asarray(_start(x, y)))
    ex, ey = np.full(256, ETA_WATER, np.float32), np.ones(256, np.float32)
    jwr = JM.specular_manifold_walk(jgeo, lambda o, d: intersect_brute(jgeo, o, d),
                                    jnp.asarray(x), jnp.asarray(y), h0.prim, h0.u, h0.v,
                                    jnp.asarray(ex), jnp.asarray(ey))
    wr = M.specular_manifold_walk(geo, _isect(geo), t(x), t(y), t(h0.prim), t(h0.u), t(h0.v),
                                  t(ex), t(ey))
    return geo, jgeo, x, y, ex, ey, wr, jwr


def test_walk_matches_jax(walks):
    _, _, _, _, _, _, wr, jwr = walks
    conv, jconv = wr.converged.numpy(), np.asarray(jwr.converged)
    assert (conv == jconv).mean() >= 0.99
    both = conv & jconv
    assert both.mean() > 0.95
    np.testing.assert_allclose(wr.z.numpy()[both], np.asarray(jwr.z)[both], rtol=0, atol=1e-4)
    assert wr.prim.dtype == torch.int32


def test_generalized_geometry_matches_jax(walks):
    geo, jgeo, x, y, ex, ey, wr, jwr = walks
    light_n = np.broadcast_to(np.float32([0.0, -1.0, 0.0]), (256, 3)).copy()
    dens, w = M.generalized_geometry(geo, wr, t(x), t(y), t(light_n), t(ex), t(ey))
    jdens, jw = JM.generalized_geometry(jgeo, jwr, jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(light_n), jnp.asarray(ex), jnp.asarray(ey))
    both = wr.converged.numpy() & np.asarray(jwr.converged) & (
        wr.prim.numpy() == np.asarray(jwr.prim))
    assert both.mean() > 0.95
    np.testing.assert_allclose(dens.numpy()[both], np.asarray(jdens)[both], rtol=1e-3)
    np.testing.assert_allclose(w.numpy()[both], np.asarray(jw)[both], rtol=0, atol=1e-4)


def test_walk_bars_on_the_port(walks):
    """test_walk_converges_wavy's: > 95% converged, Snell's law holds."""
    geo = walks[0]
    x, y = chip_smoke.manifold_points(256, 0, 1.5, 0.4)
    wr, _, _ = chip_smoke.manifold_walk(geo, _isect(geo), t(x), t(y))
    m = wr.converged.numpy()
    assert m.mean() > 0.95
    wi = x - wr.z.numpy()
    wo = y - wr.z.numpy()
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    nrm = wr.normal.numpy()
    sin_i = np.linalg.norm(np.cross(wi, nrm), axis=-1)
    sin_o = np.linalg.norm(np.cross(wo, nrm), axis=-1)
    np.testing.assert_allclose(ETA_WATER * sin_i[m], sin_o[m], rtol=2e-3, atol=2e-4)


def test_flat_mirror_on_the_port():
    """test_flat_mirror_matches_image_method's: the density of a mirror
    chain equals cos / r^2 at the mirrored light, within 1%."""
    geo = _port_geo(amp=0.0)
    n = 128
    x, y = chip_smoke.manifold_points(n, 1, 1.0, 0.5, x_height=2.0)
    mid = (x + y) / 2.0
    mid[:, 1] = 1.0
    isect = _isect(geo)
    h0 = isect(t(x), t(_start(x, mid)))
    ones = torch.ones((n,))
    wr = M.specular_manifold_walk(geo, isect, t(x), t(y), h0.prim, h0.u, h0.v, ones, ones)
    assert float(wr.converged.float().mean()) > 0.99
    light_n = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    dens, _ = M.generalized_geometry(geo, wr, t(x), t(y), light_n, ones, ones)
    y_img = y.copy()
    y_img[:, 1] = 2.0 - y_img[:, 1]
    diff = y_img - x
    r2 = np.sum(diff**2, -1)
    np.testing.assert_allclose(dens.numpy(), np.abs(diff[:, 1]) / np.sqrt(r2) / r2, rtol=1e-2)


def test_generalized_geometry_finite_differences_on_the_port():
    """test_generalized_geometry_matches_finite_differences's: the median
    relative difference to walks at perturbed lights under 5%."""
    geo = _port_geo(amp=0.04)
    isect = _isect(geo)
    n = 64
    x, y = chip_smoke.manifold_points(n, 2, 1.0, 0.3)
    wr, ex, ey = chip_smoke.manifold_walk(geo, isect, t(x), t(y))
    light_n = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    dens, w0 = M.generalized_geometry(geo, wr, t(x), t(y), light_n, ex, ey)
    eps = 1e-3
    ws = []
    for tv in (np.float32([1, 0, 0]), np.float32([0, 0, 1])):
        wp = chip_smoke.manifold_walk(geo, isect, t(x), t(y + eps * tv))[0].z.numpy() - x
        wm = chip_smoke.manifold_walk(geo, isect, t(x), t(y - eps * tv))[0].z.numpy() - x
        wp /= np.linalg.norm(wp, axis=-1, keepdims=True)
        wm /= np.linalg.norm(wm, axis=-1, keepdims=True)
        ws.append((wp - wm) / (2 * eps))
    w0n = w0.numpy()
    up = np.where(np.abs(w0n[:, 1:2]) < 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    b1 = np.cross(w0n, up)
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = np.cross(w0n, b1)
    fd = np.abs(np.sum(b1 * ws[0], -1) * np.sum(b2 * ws[1], -1)
                - np.sum(b1 * ws[1], -1) * np.sum(b2 * ws[0], -1))
    ok = wr.converged.numpy()
    rel = np.abs(dens.numpy()[ok] - fd[ok]) / np.maximum(fd[ok], 1e-9)
    assert np.median(rel) < 0.05, np.median(rel)


@pytest.mark.slow
def test_manifold_nee_matches_brute_force_on_the_port():
    """test_manifold_nee_matches_brute_force's: manifold NEE's irradiance
    on three floor points within 8% of brute-force refraction."""
    geo = _port_geo(amp=0.04, res=40)
    est_m, est_b = chip_smoke.manifold_nee_estimates(geo, _isect(geo), 512, 80_000)
    for a, b in zip(est_m, est_b):
        assert abs(a / b - 1.0) < chip_smoke.MANIFOLD_NEE_TOL, (est_m, est_b)
