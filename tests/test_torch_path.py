"""The port's wavefront path tracer, guiding-cache fit and progressive
renderer against the JAX package on the CPU, from the same scene, keys
and (converted) grid."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.core import rng as trng
from mitsuba_path_guiding_torch.guiding.fit import accumulate_stats, update_grid
from mitsuba_path_guiding_torch.guiding.grid import _normal_bits_to_float, cell_index, make_grid
from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
from mitsuba_path_guiding_torch.integrators.path import PathRecord, trace
from mitsuba_path_guiding_torch.integrators.progressive import (
    ProgressiveConfig,
    ProgressiveRenderer,
)
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.guiding import fit as jfit
from mitsuba_path_guiding_tpu.guiding.grid import cell_index as j_cell_index
from mitsuba_path_guiding_tpu.guiding.grid import make_grid as j_make_grid
from mitsuba_path_guiding_tpu.guiding.sampler import make_guide_fn as j_make_guide_fn
from mitsuba_path_guiding_tpu.integrators import progressive as jprog
from mitsuba_path_guiding_tpu.integrators import render as jrender
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.scenes import cornell_box as j_cornell_box
from torch_port_parity import frac_close, port_grid, t

GRID_FIELDS = ("mu", "kappa", "log_weight", "valid", "s_w", "s_dir", "s_count", "s_rho",
               "s_pos", "s_pos_w", "origin", "lobe_dist", "alpha_scale")


@pytest.fixture(scope="module")
def wave():
    """One 32x32 wave of Cornell camera rays, and one trained JAX grid."""
    jscene = j_build_scene(j_cornell_box())
    scene = build_scene(cornell_box(), device="cpu")
    n = 1024
    pix = jnp.arange(n, dtype=jnp.int32)
    kj = jrng.ray_keys(jrng.base_key(0), pix, jnp.zeros_like(pix))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o, d, _ = j_generate_rays(jscene.sensor, 32, 32, pix, u)
    g0 = j_make_grid(jscene.aabb_min, jscene.aabb_max, res=4, n_lobes=8)
    _, _, rec = j_trace(jscene, o, d, kj, max_depth=5, use_bvh=False, em_kinds=(0,),
                        mat_types=(0,), guide=j_make_guide_fn(0.5, (0,), parallax=True),
                        guide_state=g0, record_paths=True)
    jgrid = jfit.update_grid(g0, *jfit.accumulate_stats(g0, rec))
    assert int(np.asarray(jgrid.valid).sum()) > 0
    return jscene, scene, o, d, kj, jgrid


def _assert_grid_close(got, want, tol=1e-4):
    for f in GRID_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   rtol=tol, atol=tol, err_msg=f)


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("accel", ["auto", "brute"])
def test_trace_matches_reference(wave, guided, accel):
    jscene, scene, o, d, kj, jgrid = wave
    jguide = j_make_guide_fn(0.5, (0,), parallax=True) if guided else None
    Lj, auxj, recj = j_trace(jscene, o, d, kj, max_depth=5, rr_depth=3, use_bvh=False,
                             em_kinds=(0,), mat_types=(0,), guide=jguide,
                             guide_state=jgrid if guided else None, record_paths=True)
    guide = make_guide_fn(0.5, (0,), parallax=True) if guided else None
    Lt, auxt, rect = trace(scene, t(o), t(d), t(kj), max_depth=5, rr_depth=3, guide=guide,
                           guide_state=port_grid(jgrid) if guided else None,
                           record_paths=True, em_kinds=(0,), mat_types=(0,), accel=accel)
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0.0
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99
    np.testing.assert_allclose(auxt.depth_t.numpy(), np.asarray(auxj.depth_t), rtol=1e-5)
    for f in ("li", "pdf", "dist"):
        assert frac_close(getattr(rect, f).numpy().ravel(),
                          np.asarray(getattr(recj, f)).ravel(), rtol=1e-4) >= 0.99, f
    assert (rect.valid.numpy() == np.asarray(recj.valid)).mean() >= 0.99


def test_make_grid_matches_reference(wave):
    jscene, scene, *_ = wave
    gj = j_make_grid(jscene.aabb_min, jscene.aabb_max, res=4, n_lobes=8, seed=5)
    gt = make_grid(scene.aabb_min, scene.aabb_max, res=4, n_lobes=8, seed=5)
    _assert_grid_close(gt, gj, tol=1e-5)
    assert (gt.res0, gt.n_used) == (4, 64)
    # the normals behind the cold-start lobes of a 16^3 grid of 8 lobes
    # (seed 0): XLA's float32 erf_inv, so nearly all are bit-equal
    shape = (16**3, 8, 3)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), shape))
    got = _normal_bits_to_float(trng.random_bits(trng.base_key(0), want.size)).numpy()
    assert (got.reshape(shape) == want).mean() >= 0.99
    assert np.abs(got.reshape(shape) - want).max() <= 2.5e-7


def test_cell_index_matches_reference(wave):
    jscene, scene, *_ , jgrid = wave
    rs = np.random.default_rng(0)
    lo, hi = np.asarray(jscene.aabb_min), np.asarray(jscene.aabb_max)
    p = (lo - 0.1 + (hi - lo + 0.2) * rs.random((4096, 3))).astype(np.float32)
    want = np.asarray(j_cell_index(jgrid, jnp.asarray(p)))
    np.testing.assert_array_equal(cell_index(port_grid(jgrid), torch.from_numpy(p)).numpy(), want)


def test_accumulate_and_update_match_reference(wave):
    jscene, scene, o, d, kj, jgrid = wave
    _, _, rec = j_trace(jscene, o, d, kj, max_depth=5, use_bvh=False, em_kinds=(0,),
                        mat_types=(0,), guide=j_make_guide_fn(0.5, (0,), parallax=True),
                        guide_state=jgrid, record_paths=True)
    sj = jfit.accumulate_stats(jgrid, rec)
    gt = port_grid(jgrid)
    st = accumulate_stats(gt, PathRecord(*(t(x) for x in rec)))
    assert len(st) == len(sj) == 6
    for a, b in zip(sj, st):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4, atol=1e-4)
    _assert_grid_close(update_grid(gt, *(t(x) for x in sj)), jfit.update_grid(jgrid, *sj))


def test_progressive_matches_reference_and_unguided(wave):
    jscene, scene = wave[:2]
    kw = dict(samples_per_progression=2, n_progressions=2, guiding=True, grid_res=4, n_lobes=8)
    jr = jprog.ProgressiveRenderer(jscene, jprog.ProgressiveConfig(
        render=jrender.RenderConfig(width=16, height=16, spp=0, max_depth=5), **kw))
    img_j = np.asarray(jr.render())
    pr = ProgressiveRenderer(scene, ProgressiveConfig(
        render=RenderConfig(width=16, height=16, spp=0, max_depth=5), **kw))
    img_t = pr.render().numpy()
    assert img_t.shape == (16, 16, 3) and np.isfinite(img_t).all()
    assert pr.sample_counter == 4 and int(pr.grid.valid.sum()) > 0
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 0.02
    _assert_grid_close(pr.grid, jr.grid, tol=1e-3)
    img_u = render(scene, RenderConfig(width=16, height=16, spp=64, max_depth=5, seed=9)).numpy()
    assert abs(img_t.mean() - img_u.mean()) / img_u.mean() < 0.05


def test_unguided_render_matches_reference(wave):
    jscene, scene = wave[:2]
    img_j = np.asarray(jrender.render(jscene, jrender.RenderConfig(width=16, height=16, spp=2)))
    img_t = render(scene, RenderConfig(width=16, height=16, spp=2)).numpy()
    assert frac_close(img_t.reshape(-1, 3), img_j.reshape(-1, 3), rtol=1e-4) >= 0.99


@pytest.mark.parametrize("guide_flag", ["-g", "-G"])
def test_cli_renders_cornell_on_the_cpu(tmp_path, guide_flag):
    from mitsuba_path_guiding_torch.render import main

    out = tmp_path / "cornell.npy"
    assert main(["cornell", "-o", str(out), "-s", "4", "-p", "2", "-d", "3", "-r", "12x8",
                 guide_flag, "--seed", "1", "--device", "cpu"]) == 0
    img = np.load(out)
    assert img.shape == (8, 12, 3) and np.isfinite(img).all() and img.mean() > 0.0


def test_active_levels_follows_the_topology(wave):
    from mitsuba_path_guiding_torch.guiding.grid import MAX_REFINE_LEVELS, active_levels
    from mitsuba_path_guiding_tpu.guiding.grid import active_levels as j_active_levels

    jscene, scene, *_ = wave
    flat = make_grid(scene.aabb_min, scene.aabb_max, res=4, n_lobes=8, capacity=72)
    refined = flat._replace(child_base=flat.child_base.clone().index_fill_(0, torch.tensor([5]), 64))
    assert active_levels(flat) == 0 and active_levels(refined) == MAX_REFINE_LEVELS
    jflat = j_make_grid(jscene.aabb_min, jscene.aabb_max, res=4, n_lobes=8, capacity=72)
    assert j_active_levels(jflat) == 0
    assert j_active_levels(jflat._replace(child_base=jnp.asarray(refined.child_base.numpy()))) \
        == MAX_REFINE_LEVELS
    # a point in the upper octant of root cell 5 = (0, 1, 1) walks into child 64 + 7
    lo, hi = scene.aabb_min, scene.aabb_max
    p = (lo + (hi - lo) * torch.tensor([0.2, 0.45, 0.45]))[None, :]
    assert int(cell_index(flat, p)[0]) == 5
    assert int(cell_index(refined, p)[0]) == 71
    jref = jflat._replace(child_base=jnp.asarray(refined.child_base.numpy()))
    assert int(np.asarray(j_cell_index(jref, jnp.asarray(p.numpy())))[0]) == 71
