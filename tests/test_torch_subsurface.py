"""The port's subsurface scattering (``integrators/subsurface.py``)
against the JAX package on the CPU.

``_fdr`` and ``dipole_mo`` on the same inputs (rtol 1e-5; the sample set
through ``convert.ss_samples_from_numpy``); ``sample_surface_points``
bit-equal on the translucent slab and on a Cornell box with two
subsurface rows; ``compute_irradiance`` within rtol 1e-5;
``render_subsurface`` on the slab (the dipole), on the single-scattering
sphere (g 0.8) and on the two-row Cornell box at 16x16 within rtol 1e-4
on >= 99% of the pixels and their means within 1e-4.  The scenes are
tests/test_subsurface.py's (chip_smoke.py ``subsurface_descs``).  The
JAX tests' twins run the port alone with their bars; the renders' twins
are ``slow``, as theirs are.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import subsurface_descs
from mitsuba_path_guiding_torch.convert import ss_samples_from_numpy
from mitsuba_path_guiding_torch.integrators import subsurface
from mitsuba_path_guiding_torch.integrators.render import RenderConfig
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_tpu.integrators import subsurface as jsubsurface
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, port_scene, to_numpy_tree

SLAB_CFG = dict(width=16, height=16, spp=2, max_depth=2, seed=3)


def _two_row_cornell(m):
    sc = m.cornell_box()
    sc["shapes"][5]["subsurface"] = {"sigma_a": [0.02, 0.04, 0.1], "sigma_s": [1.2, 1.0, 0.8],
                                     "eta": 1.3}
    sc["shapes"][6]["subsurface"] = {"type": "singlescatter", "sigma_a": 0.05, "sigma_s": 0.8,
                                     "eta": 1.33, "g": 0.5}
    return sc


@pytest.fixture(scope="module")
def scenes():
    descs = {**subsurface_descs(jscenes), "cornell2": _two_row_cornell(jscenes)}
    out = {}
    for name in ("slab", "single_g08", "cornell2"):
        js = j_build_scene(descs[name])
        out[name] = (js, port_scene(js))
    return out


def _row(eta=1.5):
    return np.asarray([0.01, 0.02, 0.03, 1.0, 0.8, 0.6, eta, 1.0] + [0.0] * 8, np.float32)


def test_fdr_matches_jax():
    eta = np.linspace(0.5, 2.5, 41).astype(np.float32)
    np.testing.assert_allclose(subsurface._fdr(torch.from_numpy(eta)).numpy(),
                               np.asarray(jsubsurface._fdr(jnp.asarray(eta))), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("eta", [0.8, 1.3])
def test_dipole_mo_matches_jax(eta):
    gen = np.random.default_rng(7)
    s, n = 96, 40
    pts = {"pos": gen.uniform(-1, 1, (s, 3)), "normal": np.tile([0.0, 0.0, 1.0], (s, 1)),
           "E": gen.uniform(0, 3, (s, 3)), "area": gen.uniform(0.01, 0.1, s),
           "sid": np.zeros(s, np.int32)}
    pts = {k: np.asarray(v, np.int32 if k == "sid" else np.float32) for k, v in pts.items()}
    x = gen.uniform(-1, 1, (n, 3)).astype(np.float32)
    want = np.asarray(jsubsurface.dipole_mo(jnp.asarray(_row(eta)), jnp.asarray(x),
                                            jsubsurface.SSSamples(**pts)))
    got = subsurface.dipole_mo(torch.from_numpy(_row(eta)), torch.from_numpy(x),
                               ss_samples_from_numpy(pts, device="cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7 * np.abs(want).max())


def test_dipole_kernel_decays_twin():
    """tests/test_subsurface.py's test_dipole_kernel_decays on the port."""
    row = torch.tensor([0.01, 0.01, 0.01, 1.0, 1.0, 1.0, 1.5, 1.0] + [0.0] * 8)
    samples = subsurface.SSSamples(pos=torch.zeros((1, 3)),
                                   normal=torch.tensor([[0.0, 0.0, 1.0]]), E=torch.ones((1, 3)),
                                   area=torch.ones((1,)), sid=torch.zeros((1,), dtype=torch.int32))
    xs = torch.stack([torch.linspace(0.0, 3.0, 16), torch.zeros(16), torch.zeros(16)], dim=-1)
    mo = subsurface.dipole_mo(row, xs, samples).numpy()
    assert np.isfinite(mo).all() and (mo >= 0).all()
    assert (np.diff(mo[:, 0]) <= 1e-9).all()
    assert mo[0, 0] > mo[-1, 0] * 10


@pytest.mark.parametrize("name,n,seed", [("slab", 512, 1), ("cornell2", 300, 4)])
def test_sample_surface_points_bit_equal(scenes, name, n, seed):
    js, ps = scenes[name]
    want = jsubsurface.sample_surface_points(js, n, seed=seed)
    got = subsurface.sample_surface_points(ps, n, seed=seed)
    for f in want._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    if name == "cornell2":
        assert set(np.unique(got.sid.numpy())) == {0, 1}


def test_sample_surface_points_needs_a_tagged_shape():
    with pytest.raises(ValueError, match="no subsurface"):
        subsurface.sample_surface_points(build_scene(tscenes.cornell_box(), device="cpu"), 8)


def test_compute_irradiance_matches_jax(scenes):
    js, ps = scenes["slab"]
    jpts = jsubsurface.sample_surface_points(js, 512, seed=1)
    want = np.asarray(jsubsurface.compute_irradiance(js, jpts, JRenderConfig(**SLAB_CFG)).E)
    got = subsurface.compute_irradiance(ps, ss_samples_from_numpy(to_numpy_tree(jpts),
                                                                  device="cpu"),
                                        RenderConfig(**SLAB_CFG)).E.numpy()
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * want.max())


@pytest.mark.parametrize("name,cfg,kw", [
    ("slab", SLAB_CFG, {"n_points": 512}),
    ("single_g08", dict(width=16, height=16, spp=2, seed=0), {}),
    ("cornell2", dict(width=16, height=16, spp=1, seed=2), {"n_points": 256}),
])
def test_render_subsurface_matches_jax(scenes, name, cfg, kw):
    js, ps = scenes[name]
    want = np.asarray(jsubsurface.render_subsurface(js, JRenderConfig(**cfg), **kw))
    got = subsurface.render_subsurface(ps, RenderConfig(**cfg), **kw).numpy()
    assert np.isfinite(got).all() and got.mean() > 0
    assert got.mean() == pytest.approx(float(want.mean()), rel=1e-4)
    assert frac_close(got, want, rtol=1e-4, atol=1e-6) >= 0.99


def test_render_subsurface_needs_rows():
    with pytest.raises(ValueError, match="no subsurface"):
        subsurface.render_subsurface(build_scene(tscenes.cornell_box(), device="cpu"),
                                     RenderConfig(width=4, height=4, spp=1))


# ---- twins of tests/test_subsurface.py (the port alone, the JAX tests' bars)

@pytest.fixture(scope="module")
def port_descs():
    return subsurface_descs(tscenes)


@pytest.mark.slow
def test_translucent_slab_glows_twin(port_descs):
    scene = build_scene(port_descs["slab"], device="cpu")
    assert scene.sss_packed is not None and scene.sss_packed.shape[0] == 1
    pts = subsurface.sample_surface_points(scene, 512, seed=1)
    assert pts.area.sum() > 0
    cfg = RenderConfig(**SLAB_CFG)
    E = subsurface.compute_irradiance(scene, pts, cfg).E.numpy()
    assert np.isfinite(E).all() and E.max() > 0
    img = subsurface.render_subsurface(scene, cfg, n_points=512).numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-4
    img2 = subsurface.render_subsurface(build_scene(port_descs["slab_thick"], device="cpu"), cfg,
                                        n_points=512).numpy()
    assert img2.mean() < img.mean() * 0.5


@pytest.mark.slow
def test_singlescatter_renders_and_scales_with_sigma_s_twin(port_descs):
    cfg = RenderConfig(width=24, height=24, spp=4, seed=0)
    img = subsurface.render_subsurface(build_scene(port_descs["single"], device="cpu"),
                                       cfg).numpy()
    assert np.isfinite(img).all() and img.mean() > 1e-4
    img_w = subsurface.render_subsurface(build_scene(port_descs["single_weak"], device="cpu"),
                                         cfg).numpy()
    assert img.mean() > 1.5 * img_w.mean()


@pytest.mark.slow
def test_singlescatter_phase_anisotropy_twin(port_descs):
    cfg = RenderConfig(width=16, height=16, spp=4, seed=0)
    a, b = (subsurface.render_subsurface(build_scene(port_descs[k], device="cpu"), cfg).numpy()
            for k in ("single", "single_g08"))
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) / max(a.mean(), 1e-9) > 0.02
