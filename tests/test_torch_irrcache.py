"""The port's irradiance cache (``integrators/irrcache.py``) against the
JAX package on the CPU.

One JAX cache (tests/test_irrcache.py's: the Cornell box, 256 records x
32 rays, depth 4, seed 2) is built once for the module.  The port builds
the same cache, compared field by field: positions and normals within
1e-5, the valid flags equal, E and R_harm within rtol 1e-4, the gradients
within rtol 1e-3 and 1e-4 of the field's largest value (a cell of one
gather ray turns XLA's contracted multiply-adds of its path into
gradient terms over distances down to 1e-4).  ``interpolate_irradiance``
on that cache (converted with ``convert.irradiance_cache_from_numpy``)
and ``_wh_gradients`` on the same (R, M, N) inputs agree within rtol
1e-5 (at the records' own points on >= 95% of the lanes, and within
2e-3 of the largest value on every lane: a record's distance to its own
point, |p|^2 + |x|^2 - 2 p.x, and 1 - n.n are float32 rounding noise
there, and its weight their inverse); ``render_irrcache`` at 16x16 from the converted cache within rtol
1e-4 on >= 99% of the pixels, by the tiled route and by the BVH.  The
JAX tests' four twins run the port alone with their bars and are
``slow``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.convert import irradiance_cache_from_numpy
from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.math import Frame
from mitsuba_path_guiding_torch.core.warp import square_to_cosine_hemisphere
from mitsuba_path_guiding_torch.integrators import irrcache
from mitsuba_path_guiding_torch.integrators.path import _offset_ray, trace
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.transforms import look_at, rotate, scale, translate
from mitsuba_path_guiding_tpu.integrators import irrcache as jirrcache
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.scenes import cornell_box
from torch_port_parity import frac_close, port_scene, to_numpy_tree

CACHE_CFG = dict(width=8, height=8, spp=1, max_depth=4, seed=2)
N_RECORDS, RAYS = 256, 32
FIELD_TOL = {"pos": (0.0, 1e-5), "normal": (0.0, 1e-5), "E": (1e-4, 1e-6),
             "R_harm": (1e-4, 1e-6), "grad_t": (1e-3, 1e-4), "grad_r": (1e-3, 1e-4)}


@pytest.fixture(scope="module")
def cornell():
    jscene = j_build_scene(cornell_box())
    return jscene, port_scene(jscene)


@pytest.fixture(scope="module")
def jax_cache(cornell):
    return jirrcache.build_irradiance_cache(cornell[0], JRenderConfig(**CACHE_CFG),
                                            n_records=N_RECORDS, rays_per_record=RAYS)


@pytest.fixture(scope="module")
def port_cache(jax_cache):
    return irradiance_cache_from_numpy(to_numpy_tree(jax_cache), device="cpu")


def test_build_irradiance_cache_matches_jax(cornell, jax_cache):
    got = irrcache.build_irradiance_cache(cornell[1], RenderConfig(**CACHE_CFG),
                                          n_records=N_RECORDS, rays_per_record=RAYS)
    assert int(got.valid.sum()) > 100
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(jax_cache.valid))
    for f, (rtol, atol) in FIELD_TOL.items():
        a, b = getattr(got, f).numpy(), np.asarray(getattr(jax_cache, f))
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * max(1.0, np.abs(b).max()),
                                   err_msg=f)


def test_interpolate_irradiance_matches_jax(jax_cache, port_cache):
    gen = np.random.default_rng(5)
    n = 64
    pts = np.stack([gen.uniform(-0.9, 0.9, n), gen.uniform(0.0, 1.9, n),
                    gen.uniform(-0.9, 0.9, n)], -1).astype(np.float32)
    ns = gen.normal(size=(n, 3)).astype(np.float32)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    cases = [(np.array(jax_cache.pos), np.array(jax_cache.normal), 0.3, True),
             (pts, ns, 0.4, False)]
    for p, nrm, err, at_records in cases:
        for grads in (True, False):
            want = np.asarray(jirrcache.interpolate_irradiance(
                jax_cache, jnp.asarray(p), jnp.asarray(nrm), max_error=err,
                use_gradients=grads))
            got = irrcache.interpolate_irradiance(port_cache, torch.from_numpy(p),
                                                  torch.from_numpy(nrm), max_error=err,
                                                  use_gradients=grads, chunk=100).numpy()
            scale = np.abs(want).max()
            if at_records:
                # a record's own distance |p|^2 + |x|^2 - 2 p.x and 1 - n.n
                # are float32 rounding noise there, and its weight 1 / noise
                assert frac_close(got, want, rtol=1e-5, atol=1e-6 * scale) >= 0.95
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3 * scale)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def test_wh_gradients_matches_jax():
    gen = np.random.default_rng(3)
    R, M, N = 32, 4, 16
    L = gen.uniform(0.0, 2.0, (R, M, N, 3)).astype(np.float32)
    r = gen.uniform(0.01, 3.0, (R, M, N)).astype(np.float32)
    r[gen.random((R, M, N)) < 0.2] = 3.0e37  # open cells
    want = jirrcache._wh_gradients(jnp.asarray(L), jnp.asarray(r), M, N)
    got = irrcache._wh_gradients(torch.from_numpy(L), torch.from_numpy(r), M, N)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("accel", ["auto", "bvh"])
def test_render_irrcache_matches_jax(cornell, jax_cache, port_cache, accel):
    want = np.asarray(jirrcache.render_irrcache(
        cornell[0], JRenderConfig(width=16, height=16, spp=2, max_depth=4, seed=5),
        cache=jax_cache))
    got = irrcache.render_irrcache(cornell[1], RenderConfig(width=16, height=16, spp=2,
                                                            max_depth=4, seed=5, accel=accel),
                                   cache=port_cache).numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    assert got.mean() == pytest.approx(float(want.mean()), rel=1e-4)
    assert frac_close(got, want, rtol=1e-4, atol=1e-6) >= 0.99


# ---- twins of tests/test_irrcache.py (the port alone, the JAX tests' bars)

@pytest.fixture(scope="module")
def port_cornell():
    return build_scene(tscenes.cornell_box(), device="cpu")


@pytest.mark.slow
def test_cache_build_twin(port_cornell):
    cache = irrcache.build_irradiance_cache(port_cornell, RenderConfig(**CACHE_CFG),
                                            n_records=256, rays_per_record=32)
    E, ok = cache.E.numpy(), cache.valid.numpy()
    assert ok.sum() > 100
    assert np.isfinite(E).all() and (E >= 0).all()
    assert E[ok].mean() > 1e-3
    R = cache.R_harm.numpy()[ok]
    assert (R > 0).all() and R.mean() < 10.0
    Ei = irrcache.interpolate_irradiance(cache, cache.pos, cache.normal, max_error=0.3).numpy()
    rel = np.abs(Ei[ok] - E[ok]).sum(-1) / np.maximum(E[ok].sum(-1), 1e-6)
    assert np.median(rel) < 0.5


@pytest.mark.slow
def test_irrcache_matches_pt_twin(port_cornell):
    img_pt = render(port_cornell, RenderConfig(width=16, height=16, spp=192, max_depth=4,
                                               seed=3)).numpy()
    img_ic = irrcache.render_irrcache(port_cornell, RenderConfig(width=16, height=16, spp=8,
                                                                 max_depth=4, seed=5),
                                      n_records=512, rays_per_record=64).numpy()
    assert np.isfinite(img_ic).all()
    assert 0.8 < img_ic.mean() / img_pt.mean() < 1.2


def _record_E_at(scene, pts, ns, rays=4096, seed=91):
    """Brute-force indirect irradiance at the points (the JAX test's
    oracle, through the port's trace)."""
    n = pts.shape[0]
    rpos = torch.from_numpy(np.repeat(np.asarray(pts, np.float32), rays, axis=0))
    rns = torch.from_numpy(np.repeat(np.asarray(ns, np.float32), rays, axis=0))
    lane = torch.arange(n * rays, dtype=torch.int32)
    rk = rng.ray_keys(rng.base_key(seed), lane, torch.zeros_like(lane))
    d = Frame.from_normal(rns).to_world(square_to_cosine_hemisphere(
        rng.event_uniform(rk, 3 << 20, 2)))
    L, aux, _ = trace(scene, _offset_ray(rpos, rns, d), d, rk, max_depth=2, use_nee=True)
    return np.pi * (L - aux.first_le).numpy().reshape(n, rays, 3).mean(axis=1)


@pytest.mark.slow
def test_gradients_predict_directional_derivative_twin():
    scene = build_scene({
        "sensor": {"type": "perspective", "fov": 60,
                   "to_world": look_at([0, 2.0, -3.5], [0, 0, 0])},
        "shapes": [
            {"type": "rectangle", "to_world": rotate([1, 0, 0], -90) @ scale(3.0),
             "bsdf": {"type": "diffuse", "reflectance": [0.6] * 3}},
            {"type": "rectangle",
             "to_world": translate(0.0, 1.5, 2.0) @ rotate([1, 0, 0], 180) @ scale(3.0),
             "bsdf": {"type": "diffuse", "reflectance": [0.9] * 3}},
        ],
        "emitters": [{"type": "point", "position": [0.5, 1.0, -1.5],
                      "intensity": [30.0] * 3}],
    }, device="cpu")
    cache = irrcache.build_irradiance_cache(scene, RenderConfig(**CACHE_CFG), n_records=256,
                                            rays_per_record=256)
    pos, nrm, ok = cache.pos.numpy(), cache.normal.numpy(), cache.valid.numpy()
    floor = ok & (nrm[:, 1] > 0.99) & (np.abs(pos[:, 0]) < 1.0) & (np.abs(pos[:, 2]) < 1.0) \
        & (pos[:, 1] < 0.01)
    idx = np.where(floor)[0][:6]
    assert idx.size >= 3
    h = 0.15
    checked = 0
    for i in idx:
        g = cache.grad_t.numpy()[i]
        for tang in ([1.0, 0.0, 0.0], [0.0, 0.0, 1.0]):
            t = np.asarray(tang)
            Epm = _record_E_at(scene, np.stack([pos[i] + h * t, pos[i] - h * t]),
                               np.stack([nrm[i], nrm[i]]), rays=16384)
            dnum = (Epm[0] - Epm[1]).mean() / (2 * h)
            dpred = (t @ g).mean()
            if abs(dnum) > 0.1:
                checked += 1
                assert np.sign(dnum) == np.sign(dpred), (i, tang, dnum, dpred)
                assert 0.3 < abs(dpred) / abs(dnum) < 3.0, (i, tang, dnum, dpred)
    assert checked >= 2


@pytest.mark.slow
def test_gradient_interpolation_beats_ward_only_twin(port_cornell):
    cache = irrcache.build_irradiance_cache(port_cornell, RenderConfig(**CACHE_CFG),
                                            n_records=256, rays_per_record=128)
    gen = np.random.default_rng(5)
    n = 24
    pts = np.stack([gen.uniform(-0.7, 0.7, n), np.zeros(n), gen.uniform(-0.7, 0.7, n)],
                   axis=-1).astype(np.float32)
    ns = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), (n, 3)).copy()
    ref = _record_E_at(port_cornell, pts, ns, rays=8192)
    e_g, e_w = (irrcache.interpolate_irradiance(cache, torch.from_numpy(pts),
                                                torch.from_numpy(ns), max_error=0.4,
                                                use_gradients=g).numpy() for g in (True, False))
    assert np.abs(e_g - ref).mean() < np.abs(e_w - ref).mean()
