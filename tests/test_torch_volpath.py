"""The port's volumetric path tracer against the JAX package on the CPU:
``trace_vol`` on a 16x16 wave of volumetric_box and heterogeneous_box,
unguided and guided (a numpy-made vMF grid), with guided distance
sampling, with records, and with every non-HG phase kind; the render
entry points (``render_wave``'s volume branch and the firefly clamp
against JAX's, ``render_scanned`` bit-equal to ``render``, the
progressive renderer against JAX's and the CLI's ``volbox``).

Tolerances, those of tests/test_torch_path.py: per-lane radiance and
record fields rtol 1e-4 on >= 99% of lanes (XLA on the CPU contracts
multiply-adds; a cube root or an exponential can differ in the last bit),
n_bounces and the record flags equal on >= 99%; bit-equality where both
sides run the same port code.  Each distinct JAX trace compiles once:
the cases share one scene and one wave per scene."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
from mitsuba_path_guiding_torch.integrators.progressive import (
    ProgressiveConfig,
    ProgressiveRenderer,
)
from mitsuba_path_guiding_torch.integrators.render import (
    RenderConfig,
    render,
    render_scanned,
    render_wave,
)
from mitsuba_path_guiding_torch.integrators.volpath import trace_vol
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.guiding.grid import make_grid as j_make_grid
from mitsuba_path_guiding_tpu.guiding.sampler import make_guide_fn as j_make_guide_fn
from mitsuba_path_guiding_tpu.integrators import progressive as jprog
from mitsuba_path_guiding_tpu.integrators import render as jrender
from mitsuba_path_guiding_tpu.integrators.volpath import trace_vol as j_trace_vol
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, port_grid, port_scene, t

W = H = 16
# every fitted field of the guiding grid (tests/test_torch_path.py's list)
GRID_FIELDS = ("mu", "kappa", "log_weight", "valid", "s_w", "s_dir", "s_count", "s_rho",
               "s_pos", "s_pos_w", "origin", "lobe_dist", "alpha_scale")
PHASE_PATCH = {
    "rayleigh": {"phase": "rayleigh"},
    "kkay": {"phase": "kkay", "orientation": [0.3, 0.5, 0.81], "ks": 0.4, "kd": 0.2,
             "exponent": 4.0},
    "microflake": {"phase": "microflake", "orientation": [0.0, 0.0, 1.0], "stddev": 0.25},
    "mixture": {"phase": "mixture", "phase_weights": [0.5, 0.3, 0.2],
                "phase_components": [{"type": "hg", "g": 0.6}, {"type": "rayleigh"},
                                     {"type": "hg", "g": -0.4}]},
}


def _random_grid(jscene, seed):
    """A JAX grid of 4^3 cells with numpy-made lobes, weights, validity
    and fitted flux (the guided paths read all of them)."""
    g = j_make_grid(jscene.aabb_min, jscene.aabb_max, res=4, n_lobes=8)
    rs = np.random.RandomState(seed)
    c, k = g.kappa.shape
    mu = rs.normal(size=(c, k, 3))
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    return g._replace(mu=f32(mu), kappa=f32(rs.uniform(0.5, 30.0, (c, k))),
                      log_weight=f32(rs.normal(size=(c, k))),
                      valid=jnp.asarray(rs.rand(c) < 0.8),
                      s_w=f32(rs.uniform(0.0, 2.0, (c, k))),
                      s_count=f32(rs.randint(1, 50, c)))


class _Case:
    """One scene in both packages with a 16x16 wave of camera rays."""

    def __init__(self, desc_j):
        self.jscene = j_build_scene(desc_j)
        self.scene = port_scene(self.jscene)
        pix = jnp.arange(W * H, dtype=jnp.int32)
        self.kj = jrng.ray_keys(jrng.base_key(0), pix, jnp.zeros_like(pix))
        u = jrng.event_uniform(self.kj, jrng.TAG_CAMERA, 2)
        self.o, self.d, _ = j_generate_rays(self.jscene.sensor, W, H, pix, u)
        self.jgrid = _random_grid(self.jscene, 1)
        self.grid = port_grid(self.jgrid)


@pytest.fixture(scope="module")
def cases():
    out = {"volumetric_box": _Case(jscenes.volumetric_box()),
           "heterogeneous_box": _Case(jscenes.heterogeneous_box())}
    for name, patch in PHASE_PATCH.items():
        desc = jscenes.volumetric_box(sigma_s=0.6, sigma_a=0.1)
        desc["medium"].update(patch)
        out[name] = _Case(desc)
    return out


def _compare(c, guided, guide_distance):
    med = c.jscene.medium
    kw = dict(max_depth=5, rr_depth=3, em_kinds=(0,), mat_types=(0,), record_paths=True,
              hetero=bool(med.heterogeneous), phase_kind=int(med.phase_kind),
              guide_distance=guide_distance)
    Lj, auxj, recj = j_trace_vol(
        c.jscene, c.o, c.d, c.kj, guide=j_make_guide_fn(0.5, (0,), parallax=True) if guided
        else None, guide_state=c.jgrid if guided else None, **kw)
    Lt, auxt, rect = trace_vol(
        c.scene, t(c.o), t(c.d), t(c.kj), guide=make_guide_fn(0.5, (0,), parallax=True)
        if guided else None, guide_state=c.grid if guided else None, **kw)
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0.0 and np.isfinite(Lt.numpy()).all()
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99
    valid = np.asarray(recj.valid)
    assert valid.mean() > 0.2
    assert (rect.valid.numpy() == valid).mean() >= 0.99
    both = valid & rect.valid.numpy()
    for f in ("pos", "dir", "li", "pdf"):
        a, b = np.asarray(getattr(recj, f)), getattr(rect, f).numpy()
        if a.ndim == 3:
            a, b = a.transpose(0, 2, 1), b.transpose(0, 2, 1)
        assert frac_close(b[both], a[both], rtol=1e-4) >= 0.99, f


@pytest.mark.parametrize("guided,guide_distance", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("name", ["volumetric_box", "heterogeneous_box"])
def test_trace_vol_matches_reference(cases, name, guided, guide_distance):
    """Unguided, and guided (phase and BSDF one-sample MIS with the vMF
    mixture, NEE's MIS against both) with and without guided distance
    sampling, with records for the fit."""
    _compare(cases[name], guided, guide_distance)


@pytest.mark.parametrize("name", sorted(PHASE_PATCH))
def test_trace_vol_phase_kinds_match_reference(cases, name):
    """Unguided, with records, for each phase family but HG (the
    microflake with its directional extinction)."""
    _compare(cases[name], False, False)


def _wave_cfg(**kw):
    return RenderConfig(width=W, height=H, spp=1, max_depth=5, **kw)


@pytest.mark.parametrize("name,clamp", [("volumetric_box", 0.0), ("volumetric_box", 0.05),
                                        ("heterogeneous_box", 0.0)])
def test_render_wave_volume_branch_matches_reference(cases, name, clamp):
    """render_wave on a scene with a medium takes the volumetric tracer
    unguided, with BSDF sampling (no trivial guide), as JAX's does; with
    ``max_component_value`` both clamp every component (every value at or
    below the clamp)."""
    c = cases[name]
    cfg = _wave_cfg(max_component_value=clamp)
    pix = np.arange(W * H)
    sidx = np.full(W * H, 3)
    _, Lj, auxj = jrender.render_wave(c.jscene, jrender.RenderConfig(**cfg._asdict() | {
        "use_bvh": None}), jnp.asarray(pix, jnp.int32), jnp.asarray(sidx, jnp.int32))
    _, Lt, auxt = render_wave(c.scene, cfg, torch.from_numpy(pix), torch.from_numpy(sidx))
    Lj = np.asarray(Lj)
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99
    if clamp > 0.0:
        c32 = np.float32(clamp)
        assert float(Lt.max()) <= c32 and (Lj == c32).mean() > 0.01
        assert ((Lt.numpy() == c32) == (Lj == c32)).mean() >= 0.99


@pytest.mark.parametrize("name", ["volumetric_box", "cornell_box"])
def test_render_scanned_equals_render(name):
    """The same waves in the same splat order: the same image bit for bit,
    for a medium and for the surface wavefront."""
    scene = build_scene(getattr(tscenes, name)(), device="cpu")
    cfg = RenderConfig(width=8, height=6, spp=3, max_depth=4, seed=2)
    a = render(scene, cfg)
    b = render_scanned(scene, cfg)
    assert a.mean() > 0.0
    assert torch.equal(a, b)
    # a frame of more than pixel_batch pixels renders through render()
    small = cfg._replace(pixel_batch=16)
    assert torch.equal(render_scanned(scene, small), render(scene, small))


@pytest.mark.parametrize("name", ["volumetric_box", "heterogeneous_box"])
def test_progressive_volume_matches_reference(cases, name):
    """Twin of test_torch_path.py's Cornell progressive parity on a
    medium: JAX's and the port's ProgressiveRenderer at 16x16, 2
    progressions of 2 spp, guided, with guided distance sampling, the grid
    fitted from the volumetric records.  The image per pixel rtol 1e-4 on
    >= 99% of pixels, the fitted grid's fields within 1e-3 (rtol and
    atol, as the Cornell twin)."""
    c = cases[name]
    kw = dict(samples_per_progression=2, n_progressions=2, guiding=True, grid_res=4, n_lobes=8,
              guide_distance=True)
    jr = jprog.ProgressiveRenderer(c.jscene, jprog.ProgressiveConfig(
        render=jrender.RenderConfig(width=W, height=H, spp=0, max_depth=5), **kw))
    img_j = np.asarray(jr.render())
    pr = ProgressiveRenderer(c.scene, ProgressiveConfig(
        render=RenderConfig(width=W, height=H, spp=0, max_depth=5), **kw))
    img_t = pr.render().numpy()
    assert img_t.shape == (H, W, 3) and img_j.mean() > 0.0
    assert pr.sample_counter == 4 and int(pr.grid.valid.sum()) > 0
    assert frac_close(img_t.reshape(-1, 3), img_j.reshape(-1, 3), rtol=1e-4) >= 0.99
    for f in GRID_FIELDS:
        np.testing.assert_allclose(getattr(pr.grid, f).numpy().astype(np.float64),
                                   np.asarray(getattr(jr.grid, f)).astype(np.float64),
                                   rtol=1e-3, atol=1e-3, err_msg=f)


def test_progressive_volume_render():
    """The guided progressive renderer on volumetric_box and
    heterogeneous_box: guided distance sampling on and off, the grid fitted
    from the volumetric records, the clamp bounding the film."""
    for name in ("volumetric_box", "heterogeneous_box"):
        scene = build_scene(getattr(tscenes, name)(), device="cpu")
        for gd in (True, False):
            cfg = ProgressiveConfig(render=RenderConfig(width=8, height=8, spp=0, max_depth=4,
                                                        max_component_value=2.0),
                                    samples_per_progression=2, n_progressions=2,
                                    grid_res=2, n_lobes=4, guide_distance=gd)
            ren = ProgressiveRenderer(scene, cfg)
            img = ren.render()
            assert img.shape == (8, 8, 3) and torch.isfinite(img).all()
            assert 0.0 < float(img.mean()) and float(img.max()) <= 2.0
            assert int(ren.grid.valid.sum()) > 0


def test_cli_renders_volbox_on_the_cpu(tmp_path):
    """The CLI's volbox at 32x32, 4 spp (guided progressive)."""
    from mitsuba_path_guiding_torch.render import main

    out = tmp_path / "volbox.npy"
    assert main(["volbox", "-o", str(out), "-r", "32x32", "-s", "4", "--device", "cpu"]) == 0
    img = np.load(out)
    assert img.shape == (32, 32, 3) and np.isfinite(img).all() and img.mean() > 0.0


@pytest.mark.slow
def test_guided_distance_render_unbiased():
    """Twin of tests/test_guided_distance.py::test_guided_distance_render_unbiased
    (slow there too): progressive volume renders with and without guided
    distance sampling agree with a converged analytic render."""
    scene = build_scene(tscenes.volumetric_box(sigma_s=0.5, sigma_a=0.05, g=0.0), device="cpu")
    ref = render_scanned(scene, RenderConfig(width=16, height=16, spp=512, max_depth=6, seed=42))
    r = RenderConfig(width=16, height=16, spp=16, max_depth=6, seed=0)

    def run(gd):
        cfg = ProgressiveConfig(render=r, samples_per_progression=4, n_progressions=6,
                                guiding=True, grid_res=4, n_lobes=4, guide_distance=gd)
        return ProgressiveRenderer(scene, cfg).render()

    img_g, img_a = run(True), run(False)
    assert torch.isfinite(img_g).all()
    np.testing.assert_allclose(float(img_g.mean()), float(ref.mean()), rtol=0.12)
    np.testing.assert_allclose(float(img_a.mean()), float(ref.mean()), rtol=0.12)


@pytest.mark.slow
def test_guided_distance_hetero_render_unbiased():
    """Twin of tests/test_guided_distance.py::test_guided_distance_hetero_render_unbiased."""
    scene = build_scene(tscenes.heterogeneous_box(sigma_s=0.9, sigma_a=0.1, g=0.0, res=16),
                        device="cpu")
    ref = render_scanned(scene, RenderConfig(width=12, height=12, spp=384, max_depth=6, seed=42))
    r = RenderConfig(width=12, height=12, spp=32, max_depth=6, seed=7)

    def run(gd):
        cfg = ProgressiveConfig(render=r, samples_per_progression=8, n_progressions=4,
                                guiding=True, grid_res=4, n_lobes=4, guide_distance=gd)
        return ProgressiveRenderer(scene, cfg).render()

    img_g, img_a = run(True), run(False)
    assert torch.isfinite(img_g).all()
    np.testing.assert_allclose(float(img_g.mean()), float(img_a.mean()), rtol=0.10)
    np.testing.assert_allclose(float(img_g.mean()), float(ref.mean()), rtol=0.2)
    np.testing.assert_allclose(float(img_a.mean()), float(ref.mean()), rtol=0.2)
