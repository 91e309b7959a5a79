"""The port's animation (``scene/animation.py``), deformable shapes, motion
integrators (``integrators/motion.py``) and spectral scan
(``integrators/spectral.py``) against the JAX package on the CPU.

``AnimatedTransform.eval`` (translation, rotation with both quaternion
branches, scale, a mirror, times inside and outside the keys),
``scene_at_time`` and ``deformable_at`` equal to the reference's bit for
bit; a deformable shape compiles to the reference's arrays at its
``time`` property; ``render_motion`` at 24x24 within 1e-4 of the
reference's on every pixel whose first hit is the same triangle (>= 99%:
a silhouette ray one float32 rounding apart may hit the other surface);
``render_motion_blur`` (the sliding sphere and the deformable plane) and
``render_spectral_scan`` (the hero scene's packed bins and the dispersive
sphere's single bins, both branches of ``_has_dispersion``) at 16x16 x 4
spp: image means within 0.5% of the reference's and >= 99% of the
pixels within rtol 1e-5 (atol 1e-6).  The twins of the JAX package's slow
motion and spectral tests run the port alone with their bars and are
``slow``.
"""
import copy
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mitsuba_path_guiding_torch.accel.traverse import INF
from mitsuba_path_guiding_torch.integrators.motion import render_motion, render_motion_blur
from mitsuba_path_guiding_torch.integrators.path import route_dense_or_bvh
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.integrators.spectral import render_spectral, render_spectral_scan
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene import animation as A
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.transforms import rotate, scale, translate
from mitsuba_path_guiding_tpu.accel.traverse import intersect_brute
from mitsuba_path_guiding_tpu.integrators.motion import render_motion as j_render_motion
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene import animation as JA
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from test_torch_scene import _compare
from torch_port_parity import assert_tree_equal, frac_close

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import slice13_reference_means as ref  # noqa: E402

MEAN_RTOL = 5e-3
PIX_RTOL, PIX_ATOL, PIX_SHARE = 1e-5, 1e-6, 0.99
SMALL_RES, SMALL_SPP = 16, 4


@pytest.fixture(scope="module")
def descs():
    return chip_smoke.slice13_descs(tscenes), chip_smoke.slice13_descs(jscenes)


def _tracks():
    return [
        ([0.0, 1.0], [translate(0, 0, 0), translate(2.0, 0, 0)]),
        ([0.0, 1.0], [rotate([0, 0, 1], 0.0), rotate([0, 0, 1], 90.0)]),
        ([0.0, 0.5, 2.0], [scale(1.0), rotate([1, 1, 0], 170.0) @ scale(2.0, 1.0, 0.5),
                           translate(1, 2, 3) @ rotate([0, 1, 0], -120.0)]),
        ([1.0, 0.0], [np.diag([-1.0, 1.0, 1.0, 1.0]), rotate([0, 1, 1], 179.0)]),
        ([0.3], [translate(0.5, -1.0, 2.0)]),
    ]


def test_animated_transform_equals_jax():
    for times, mats in _tracks():
        a, ja = A.AnimatedTransform(times, mats), JA.AnimatedTransform(times, mats)
        assert a.is_static == ja.is_static
        for tq in (-1.0, 0.0, 0.1, 0.25, 0.5, 0.77, 1.0, 1.6, 2.0, 9.0):
            np.testing.assert_array_equal(a.eval(tq), ja.eval(tq))
        spec = {"times": times, "transforms": mats}
        np.testing.assert_array_equal(A.AnimatedTransform.from_spec(spec).eval(0.4),
                                      JA.AnimatedTransform.from_spec(spec).eval(0.4))
    np.testing.assert_array_equal(A.AnimatedTransform.from_spec(translate(1, 2, 3)).eval(0.5),
                                  translate(1, 2, 3))
    for k in range(4):
        m = rotate([1, 2, 3], 45.0 * k + 170.0)
        for x, y in zip(A._decompose(m), JA._decompose(m)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["moving_0.4", "deformable"])
def test_scene_at_time_equals_jax(descs, name):
    desc = copy.deepcopy(descs[0][name])
    desc["sensor"]["animation"] = {"times": [0.0, 1.0], "transforms": [
        desc["sensor"]["to_world"], translate(0.1, 0, 0) @ desc["sensor"]["to_world"]]}
    for tq in (0.0, 0.3, 0.5, 1.0, 1.5):
        assert_tree_equal(A.scene_at_time(desc, tq), JA.scene_at_time(desc, tq))
    sh = descs[0]["deformable"]["shapes"][0]
    for tq in (-0.5, 0.0, 0.5, 0.9, 3.0):
        assert_tree_equal(A.deformable_at(sh, tq), JA.deformable_at(sh, tq))
    three = dict(sh, vertices_frames=[*sh["vertices_frames"], sh["vertices_frames"][0]],
                 times=[0.0, 0.2, 1.0])
    assert_tree_equal(A.deformable_at(three, 0.6), JA.deformable_at(three, 0.6))


@pytest.mark.parametrize("time", [None, 0.0, 0.35, 1.0])
def test_deformable_compiles_like_jax(descs, time):
    desc = copy.deepcopy(descs[0]["deformable"])
    if time is not None:
        desc["shapes"][0]["time"] = time
    _compare(build_scene(desc, device="cpu"), j_build_scene(desc), "deformable")


def test_render_motion_matches_jax(descs):
    res = 24
    desc, jdesc = descs[0]["moving_0.4"], descs[1]["moving_0.4"]
    got = render_motion(desc, RenderConfig(width=res, height=res, spp=1), device="cpu").numpy()
    want = np.asarray(j_render_motion(jdesc, JRenderConfig(width=res, height=res, spp=1)))
    # the first hits of both packages' camera rays at t0
    pix = np.arange(res * res)
    u = np.full((res * res, 2), 0.5, np.float32)
    sc = build_scene(A.scene_at_time(desc, 0.0), device="cpu")
    o, d, _ = generate_rays(sc.sensor, res, res, torch.as_tensor(pix), torch.as_tensor(u))
    prim = route_dense_or_bvh(sc)[0](o, d, torch.full((res * res,), INF)).prim.numpy()
    jsc = j_build_scene(JA.scene_at_time(jdesc, 0.0))
    jo, jd, _ = j_generate_rays(jsc.sensor, res, res, jnp.asarray(pix, jnp.int32), jnp.asarray(u))
    same = (prim == np.asarray(intersect_brute(jsc.geo, jo, jd).prim)).reshape(res, res)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-4)
    summary = ref.motion_vector_summary(got)
    assert summary["moving"] > 10 and summary["mean_dx_moving"] > 0


def _image_parity(got, want):
    assert np.isfinite(got).all()
    assert abs(got.mean() / want.mean() - 1.0) < MEAN_RTOL
    assert frac_close(got, want, rtol=PIX_RTOL, atol=PIX_ATOL) >= PIX_SHARE


@pytest.mark.parametrize("run", ["blur", "deformable"])
def test_render_motion_blur_matches_jax(descs, run):
    name, _, _, depth, seed, bins = chip_smoke.MOTION_RUNS[run]
    cfg = RenderConfig(width=SMALL_RES, height=SMALL_RES, spp=SMALL_SPP, max_depth=depth, seed=seed)
    got = render_motion_blur(descs[0][name], cfg, time_bins=bins, device="cpu").numpy()
    _image_parity(got, ref.jax_motion_blur(run, descs[1], seed, SMALL_RES, SMALL_SPP))


@pytest.mark.parametrize("run", ["hero_scan", "dispersive_bins"])
def test_render_spectral_scan_matches_jax(descs, run):
    name, _, _, _, depth, seed, n_bins = chip_smoke.SPECTRAL_RUNS[run]
    cfg = RenderConfig(width=SMALL_RES, height=SMALL_RES, spp=SMALL_SPP, max_depth=depth, seed=seed)
    got = render_spectral_scan(descs[0][name], cfg, n_bins=n_bins, device="cpu")
    _image_parity(got, ref.jax_spectral(run, descs[1], seed, SMALL_RES, SMALL_SPP, kind="scan"))


# ---- the JAX package's slow tests on the port alone

@pytest.mark.slow
def test_motion_vectors_point_along_movement_on_the_port(descs):
    mv = render_motion(descs[0]["moving_0.4"], RenderConfig(width=24, height=24, spp=1),
                       device="cpu").numpy()
    assert np.isfinite(mv).all()
    moving = np.abs(mv[..., 0]) > 0.2
    assert moving.sum() > 10
    assert (mv[..., 0][moving] > 0).all()
    assert np.abs(mv[..., 1]).max() < np.abs(mv[..., 0]).max() * 0.2
    assert (np.abs(mv[..., 0]) < 1e-5).sum() > mv[..., 0].size * 0.3


@pytest.mark.slow
def test_motion_blur_smears_on_the_port(descs):
    cfg = RenderConfig(width=24, height=24, spp=8, max_depth=2, seed=1)
    sharp = render_motion_blur(descs[0]["moving_0"], cfg, time_bins=2, device="cpu").numpy()
    blurred = render_motion_blur(descs[0]["moving_1.2"], cfg, time_bins=6, device="cpu").numpy()
    assert np.isfinite(blurred).all()
    gx_s = np.abs(np.diff(sharp.mean(-1), axis=1)).max()
    gx_b = np.abs(np.diff(blurred.mean(-1), axis=1)).max()
    assert gx_b < gx_s * 0.8, (gx_s, gx_b)


@pytest.mark.slow
def test_deformable_shape_lerp_and_blur_on_the_port(descs):
    sh = descs[0]["deformable"]["shapes"][0]
    mid = A.deformable_at(sh, 0.5)
    v0, v1 = sh["vertices_frames"]
    np.testing.assert_allclose(mid["vertices"], 0.5 * (v0 + v1))
    assert mid["type"] == "trimesh"
    cfg = RenderConfig(width=24, height=24, spp=8, max_depth=2, seed=0)
    img = render_motion_blur(descs[0]["deformable"], cfg, time_bins=4, device="cpu").numpy()
    sharp = render_motion_blur(descs[0]["deformable_sharp"], cfg, time_bins=2,
                               device="cpu").numpy()
    assert np.isfinite(img).all()
    assert (img[..., 0] > 1.5 * img[..., 2]).mean() > (sharp[..., 0] > 1.5 * sharp[..., 2]).mean()


@pytest.mark.slow
def test_dispersive_render_produces_fringes_on_the_port(descs):
    cfg = RenderConfig(width=24, height=24, spp=24, max_depth=5, seed=2)
    img_s = render_spectral(descs[0]["dispersive"], cfg, n_bins=4, device="cpu")
    assert np.isfinite(img_s).all() and img_s.mean() > 1e-3
    img_rgb = render(build_scene(descs[0]["dispersive"], device="cpu"), cfg).numpy()
    assert np.isfinite(img_rgb).all()

    def disparity(im):
        return np.abs(im - im.mean(-1, keepdims=True) - 1e-6).max()

    assert disparity(img_s) > 0.0


@pytest.mark.slow
def test_hero_scan_matches_per_bin_renders_on_the_port(descs):
    cfg = RenderConfig(width=16, height=16, spp=48, max_depth=3, seed=2)
    img_bins = render_spectral(descs[0]["hero"], cfg, n_bins=4, device="cpu")
    img_scan = render_spectral_scan(descs[0]["hero"], cfg, n_bins=4, device="cpu")
    assert np.isfinite(img_scan).all()
    assert abs(img_scan.mean() / max(img_bins.mean(), 1e-9) - 1.0) < 0.06
    assert np.abs(img_scan - img_bins).mean() / max(img_bins.mean(), 1e-9) < 0.25
