"""The port's guiding layer against the JAX package on the CPU: adaptive
refinement, the mixture helpers and the product mixture, the guide's
``product``, ``levels`` and ``min_rough`` options, ``fit_from_records``,
the adaptive progressive renderer; and, marked slow, the port's twins of
the JAX package's guiding acceptance tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from mitsuba_path_guiding_torch.core.math import Frame
from mitsuba_path_guiding_torch.guiding import grid as tgrid
from mitsuba_path_guiding_torch.guiding.fit import cell_sums, fit_from_records, refine_grid
from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
from mitsuba_path_guiding_torch.integrators.path import PathRecord
from mitsuba_path_guiding_torch.integrators.progressive import (
    ProgressiveConfig,
    ProgressiveRenderer,
)
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box
from mitsuba_path_guiding_torch.scene.transforms import rotate, scale, translate
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.core.math import Frame as JFrame
from mitsuba_path_guiding_tpu.guiding import fit as jfit
from mitsuba_path_guiding_tpu.guiding import grid as jgrid_mod
from mitsuba_path_guiding_tpu.guiding.sampler import make_guide_fn as j_make_guide_fn
from mitsuba_path_guiding_tpu.integrators import progressive as jprog
from mitsuba_path_guiding_tpu.integrators import render as jrender
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models.bsdf import types_present
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.scenes import cornell_box as j_cornell_box
from torch_port_parity import frac_close, port_grid, t

FLOAT_FIELDS = ("mu", "kappa", "log_weight", "s_w", "s_dir", "s_count", "s_rho", "s_pos",
                "s_pos_w", "origin", "lobe_dist", "alpha_scale")
RES, CAPACITY = 4, 8 * 4**3


@pytest.fixture(scope="module")
def fitted():
    """A JAX grid of 4^3 cells (capacity 8 * 4^3) fitted on one guided
    32x32 Cornell wave, and the JAX scene."""
    jscene = j_build_scene(j_cornell_box())
    n = 1024
    pix = jnp.arange(n, dtype=jnp.int32)
    kj = jrng.ray_keys(jrng.base_key(0), pix, jnp.zeros_like(pix))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o, d, _ = j_generate_rays(jscene.sensor, 32, 32, pix, u)
    g0 = jgrid_mod.make_grid(jscene.aabb_min, jscene.aabb_max, res=RES, n_lobes=8,
                             capacity=CAPACITY)
    _, _, rec = j_trace(jscene, o, d, kj, max_depth=5, use_bvh=False, em_kinds=(0,),
                        mat_types=(0,), guide=j_make_guide_fn(0.5, (0,), parallax=True),
                        guide_state=g0, record_paths=True)
    return jscene, jfit.update_grid(g0, *jfit.accumulate_stats(g0, rec)), rec


def _refine_both(jgrid, thresholds):
    gj, gt = jgrid, port_grid(jgrid)
    for th in thresholds:
        gj, gt = jfit.refine_grid(gj, th), refine_grid(gt, th)
    return gj, gt


def _assert_grid_equal(gt, gj):
    np.testing.assert_array_equal(gt.child_base.numpy(), np.asarray(gj.child_base))
    np.testing.assert_array_equal(gt.level.numpy(), np.asarray(gj.level))
    np.testing.assert_array_equal(gt.valid.numpy(), np.asarray(gj.valid))
    assert gt.n_used == int(np.asarray(gj.n_used))
    for f in FLOAT_FIELDS:
        a, b = np.asarray(getattr(gj, f)), getattr(gt, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint32), b.view(np.uint32)), f


# 20 splits 46 of the 56 cells that gathered samples, with room to spare;
# a second pass at 2 wants 378 splits (the 46 parents' children come in
# ties of 8) and has room for 10, so capacity cuts the sorted list
@pytest.mark.parametrize("thresholds", [(20.0,), (20.0, 2.0)], ids=["splits", "capacity"])
def test_refine_grid_equals_reference(fitted, thresholds):
    _, jgrid, _ = fitted
    gj, gt = _refine_both(jgrid, thresholds)
    _assert_grid_equal(gt, gj)
    assert gt.n_used > RES**3
    if len(thresholds) == 2:
        assert gt.n_used == CAPACITY and int(gt.level.max()) == 2


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
def test_cell_index_on_refined_grid(fitted, levels):
    jscene, jgrid, _ = fitted
    gj, gt = _refine_both(jgrid, (20.0, 2.0))
    rs = np.random.default_rng(levels)
    lo, hi = np.asarray(jscene.aabb_min), np.asarray(jscene.aabb_max)
    p = (lo - 0.1 + (hi - lo + 0.2) * rs.random((8192, 3))).astype(np.float32)
    want = np.asarray(jgrid_mod.cell_index(gj, jnp.asarray(p), levels=levels))
    got = tgrid.cell_index(gt, torch.from_numpy(p), levels=levels).numpy()
    np.testing.assert_array_equal(got, want)


def test_mixture_helpers_and_product_params(fitted):
    jscene, jgrid, _ = fitted
    gj, gt = _refine_both(jgrid, (20.0,))
    rs = np.random.default_rng(7)
    n = 4096
    cid = rs.integers(0, gt.n_used, n).astype(np.int32)
    u = rs.random((n, 3)).astype(np.float32)
    d_other = rs.normal(size=(n, 3)).astype(np.float32)
    d_other /= np.linalg.norm(d_other, axis=-1, keepdims=True)
    normal = rs.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    cj, ct = jnp.asarray(cid), torch.from_numpy(cid).long()
    kw = dict(rtol=1e-5, atol=1e-6)

    np.testing.assert_allclose(tgrid.mixture_weights(gt, ct).numpy(),
                               np.asarray(jgrid_mod.mixture_weights(gj, cj)), **kw)
    np.testing.assert_allclose(tgrid.guide_pdf(gt, ct, t(d_other)).numpy(),
                               np.asarray(jgrid_mod.guide_pdf(gj, cj, jnp.asarray(d_other))), **kw)
    np.testing.assert_allclose(
        tgrid.guide_sample(gt, ct, t(u[:, 2]), t(u[:, 0:2])).numpy(),
        np.asarray(jgrid_mod.guide_sample(gj, cj, jnp.asarray(u[:, 2]), jnp.asarray(u[:, 0:2]))),
        **kw)
    got = tgrid.guide_sample_pdf(gt, ct, t(u[:, 2]), t(u[:, 0:2]), t(d_other))
    want = jgrid_mod.guide_sample_pdf(gj, cj, jnp.asarray(u[:, 2]), jnp.asarray(u[:, 0:2]),
                                      jnp.asarray(d_other))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **kw)

    pj = jgrid_mod.product_params(jgrid_mod._gather_cells(gj, cj), jnp.asarray(normal))
    pt = tgrid.product_params(tgrid._gather_cells(gt, ct), t(normal))
    assert tgrid.KAPPA_COSINE == jgrid_mod.KAPPA_COSINE
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **kw)
    np.testing.assert_allclose(tgrid._mixture_pdf(pt, t(d_other)).numpy(),
                               np.asarray(jgrid_mod._mixture_pdf(pj, jnp.asarray(d_other))), **kw)


def _three_material_scene():
    """A floor of three rectangles, diffuse, rough conductor alpha 0.08 and
    alpha 0.5, under an area light."""
    rc = {"type": "roughconductor", "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.14]}
    floor = translate(0, 0, 0) @ rotate([1, 0, 0], -90) @ scale(0.5)
    shapes = [
        {"type": "rectangle", "to_world": translate(-1.0, 0, 0) @ floor,
         "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]}},
        {"type": "rectangle", "to_world": floor, "bsdf": {**rc, "alpha": 0.08}},
        {"type": "rectangle", "to_world": translate(1.0, 0, 0) @ floor,
         "bsdf": {**rc, "alpha": 0.5}},
        {"type": "rectangle", "to_world": translate(0, 2.0, 0) @ rotate([1, 0, 0], 90)
         @ scale(0.3), "bsdf": {"type": "diffuse", "reflectance": [0.0] * 3},
         "emitter": {"radiance": [5.0] * 3}},
    ]
    return {"shapes": shapes}


@pytest.fixture(scope="module")
def guide_lanes():
    """Lanes on the three-material scene and a refined random JAX grid
    over its box: every lobe parameter drawn from a seed."""
    spec = _three_material_scene()
    jscene, scene = j_build_scene(spec), build_scene(spec, device="cpu")
    mats_j = jscene.mats
    alpha = np.asarray(mats_j.alpha)
    mtype = np.asarray(mats_j.type)
    rs = np.random.default_rng(3)
    n = 3072
    mid = rs.integers(0, alpha.shape[0], n).astype(np.int32)
    lo, hi = np.asarray(jscene.aabb_min), np.asarray(jscene.aabb_max)
    p = (lo + (hi - lo) * rs.random((n, 3))).astype(np.float32)
    nrm = rs.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    wi = rs.normal(size=(n, 3)).astype(np.float32)
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(rs.random(n) < 0.9, 1.0, -1.0)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    d_nee = rs.normal(size=(n, 3)).astype(np.float32)
    d_nee /= np.linalg.norm(d_nee, axis=-1, keepdims=True)
    u = rs.random((n, 5)).astype(np.float32)
    pdf_b = (0.05 + rs.random(n)).astype(np.float32)

    g = jgrid_mod.make_grid(jscene.aabb_min, jscene.aabb_max, res=RES, n_lobes=4,
                            capacity=CAPACITY)
    c, k = g.kappa.shape
    mu = rs.normal(size=(c, k, 3)).astype(np.float32)
    mu /= np.linalg.norm(mu, axis=-1, keepdims=True)
    count = np.where(rs.random(c) < 0.3, 100.0, 1.0).astype(np.float32)
    g = g._replace(mu=jnp.asarray(mu),
                   kappa=jnp.asarray((0.5 + 60.0 * rs.random((c, k))).astype(np.float32)),
                   log_weight=jnp.asarray(rs.normal(size=(c, k)).astype(np.float32)),
                   valid=jnp.asarray(rs.random(c) < 0.8),
                   alpha_scale=jnp.asarray(rs.random(c).astype(np.float32)),
                   s_count=jnp.asarray(count))
    g = jfit.refine_grid(g, 50.0)
    assert int(np.asarray(g.n_used)) > RES**3
    lanes = dict(mid=mid, p=p, nrm=nrm, wi=wi, d_nee=d_nee, u=u, pdf_b=pdf_b)
    return jscene, scene, g, lanes, alpha, mtype


@pytest.mark.parametrize("levels", [0, None])
@pytest.mark.parametrize("min_rough", [0.0, 0.3])
@pytest.mark.parametrize("product", [False, True])
def test_guide_options_match_reference(guide_lanes, product, min_rough, levels):
    jscene, scene, gj, ln, alpha, mtype = guide_lanes
    mt = types_present(jscene.mats)
    jguide = j_make_guide_fn(0.5, mt, product=product, levels=levels, min_rough=min_rough)
    guide = make_guide_fn(0.5, mt, product=product, levels=levels, min_rough=min_rough)
    gt = port_grid(gj)
    jframe = JFrame.from_normal(jnp.asarray(ln["nrm"]))
    frame = Frame.from_normal(t(ln["nrm"]))
    u = ln["u"]
    args_j = (gj, jscene.mats, jnp.asarray(ln["mid"]), jnp.asarray(ln["p"]), jframe)
    args_t = (gt, scene.mats, t(ln["mid"]), t(ln["p"]), frame)
    out_j = jguide(*args_j, jnp.asarray(ln["wi"]), jnp.asarray(u[:, 0:3]),
                   jnp.asarray(u[:, 3]), jnp.asarray(u[:, 4]))
    out_t = guide(*args_t, t(ln["wi"]), t(u[:, 0:3]), t(u[:, 3]), t(u[:, 4]))
    for name, a, b in zip(("wo", "pdf", "weight"), out_t, out_j):
        assert frac_close(a.numpy(), np.asarray(b), rtol=1e-4) >= 0.99, name
    assert np.array_equal(out_t[3].numpy(), np.asarray(out_j[3]))
    pdf_j = np.asarray(jguide.pdf_at(*args_j, jnp.asarray(ln["d_nee"]), jnp.asarray(ln["pdf_b"])))
    pdf_t = guide.pdf_at(*args_t, t(ln["d_nee"]), t(ln["pdf_b"])).numpy()
    assert frac_close(pdf_t, pdf_j, rtol=1e-4) >= 0.99
    # lanes on the alpha 0.08 conductor take no guided share under the gate
    narrow = (mtype[ln["mid"]] == 3) & (alpha[ln["mid"]] < 0.3)
    wide = (mtype[ln["mid"]] == 3) & (alpha[ln["mid"]] >= 0.3)
    assert narrow.sum() > 0 and wide.sum() > 0
    guided_share = pdf_t != ln["pdf_b"]
    if min_rough > 0.0:
        assert not guided_share[narrow].any()
    else:
        assert guided_share[narrow].mean() > 0.5
    assert guided_share[wide].mean() > 0.5


def test_fit_from_records_matches_reference(fitted):
    _, jgrid, rec = fitted
    gj, gt = _refine_both(jgrid, (20.0,))
    want = jfit.update_grid(gj, *jfit.accumulate_stats(gj, rec))
    got = fit_from_records(gt, PathRecord(*(t(x) for x in rec)))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy().astype(np.float64),
                                   np.asarray(getattr(want, f)).astype(np.float64),
                                   rtol=1e-4, atol=1e-4, err_msg=f)


def test_cell_sums_add_each_cells_rows_in_row_order():
    rs = np.random.default_rng(9)
    cid = (rs.random(5000) ** 4 * 64).astype(np.int64)
    payload = rs.normal(size=(5000, 7)).astype(np.float32)
    want = np.zeros((64, 7), np.float32)
    for c, row in zip(cid, payload):
        want[c] += row
    got = cell_sums(64, torch.from_numpy(cid), torch.from_numpy(payload))
    np.testing.assert_array_equal(got.numpy(), want)


def test_adaptive_progressive_matches_reference():
    kw = dict(samples_per_progression=4, n_progressions=4, guiding=True, grid_res=4,
              n_lobes=4, adaptive_refine=True, refine_threshold=30.0, capacity_factor=8)
    jr = jprog.ProgressiveRenderer(j_build_scene(j_cornell_box()), jprog.ProgressiveConfig(
        render=jrender.RenderConfig(width=16, height=16, spp=0, max_depth=4), **kw))
    img_j = np.asarray(jr.render())
    pr = ProgressiveRenderer(build_scene(cornell_box(), device="cpu"), ProgressiveConfig(
        render=RenderConfig(width=16, height=16, spp=0, max_depth=4), **kw))
    img_t = pr.render().numpy()
    assert pr.grid.n_used == int(np.asarray(jr.grid.n_used)) > 4**3
    np.testing.assert_array_equal(pr.grid.child_base.numpy(), np.asarray(jr.grid.child_base))
    np.testing.assert_array_equal(pr.grid.level.numpy(), np.asarray(jr.grid.level))
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(pr.grid, f).numpy().astype(np.float64),
                                   np.asarray(getattr(jr.grid, f)).astype(np.float64),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    assert np.isfinite(img_t).all()
    assert abs(img_t.mean() - img_j.mean()) / img_j.mean() < 0.02


# ---- the port's twins of the JAX package's guiding acceptance tests
# (tests/test_guiding.py), each with the JAX test's own bar; the wave loop
# and the relMSE are chip_smoke.py's (bench.py's recipes)


def _cornell_reference_mean():
    scene = build_scene(cornell_box(), device="cpu")
    return scene, float(render(scene, RenderConfig(width=16, height=16, spp=64, max_depth=4,
                                                   seed=3)).mean())


@pytest.mark.slow
def test_adaptive_progressive_render_improves():
    scene, ref_mean = _cornell_reference_mean()
    cfg = ProgressiveConfig(render=RenderConfig(width=16, height=16, spp=16, max_depth=4),
                            samples_per_progression=4, n_progressions=4, guiding=True,
                            grid_res=4, n_lobes=4, adaptive_refine=True, refine_threshold=30.0,
                            capacity_factor=8)
    ren = ProgressiveRenderer(scene, cfg)
    img = ren.render().numpy()
    assert np.isfinite(img).all()
    assert ren.grid.n_used > 4**3
    np.testing.assert_allclose(img.mean(), ref_mean, rtol=0.1)


@pytest.mark.slow
def test_product_params_chi2():
    from mitsuba_path_guiding_torch.core import chi2
    from mitsuba_path_guiding_torch.guiding.fit import accumulate_stats, update_grid

    g = tgrid.make_grid(torch.zeros(3), torch.ones(3), res=1, n_lobes=4, seed=2)
    rs = np.random.RandomState(0)
    dirs = np.concatenate([rs.normal([3, 0, 1], 0.15, (4000, 3)),
                           rs.normal([0, 2, 2], 0.3, (4000, 3))])
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rec = PathRecord(pos=torch.full((1, 3, 8000), 0.5), dir=t(dirs.T[None], torch.float32),
                     li=torch.ones((1, 8000)), pdf=torch.ones((1, 8000)),
                     valid=torch.ones((1, 8000), dtype=torch.bool))
    g = update_grid(g, *accumulate_stats(g, rec))

    def product(m):
        return tgrid.product_params(tgrid._gather_cells(g, torch.zeros((m,), dtype=torch.int64)),
                                    torch.tensor([0.0, 0.0, 1.0]).expand(m, 3))

    n = 120_000
    u = torch.from_numpy(np.random.default_rng(4).random((n, 3)).astype(np.float32))
    d = tgrid._mixture_sample(product(n), u[:, 2], u[:, 0:2]).numpy()

    def pdf_fn(dirs_q):
        return tgrid._mixture_pdf(product(dirs_q.shape[0]), t(dirs_q, torch.float32)).numpy()

    passed, _, msg = chi2.chi2_test_sphere(d, pdf_fn)
    assert passed, msg


@pytest.mark.slow
def test_product_guided_render_unbiased():
    scene, ref_mean = _cornell_reference_mean()
    cfg = ProgressiveConfig(render=RenderConfig(width=16, height=16, spp=16, max_depth=4),
                            samples_per_progression=4, n_progressions=4, guiding=True,
                            grid_res=4, n_lobes=4)
    ren = ProgressiveRenderer(scene, cfg)
    ren.guide_fn = make_guide_fn(0.5, mat_types=ren.mat_types, product=True)
    img = ren.render().numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img.mean(), ref_mean, rtol=0.1)


@pytest.mark.slow
def test_guiding_beats_unguided_equal_spp():
    from mitsuba_path_guiding_torch.scene.scenes import bounce_lamp_room

    scene = build_scene(bounce_lamp_room(), device="cpu")
    grid0 = tgrid.make_grid(scene.aabb_min, scene.aabb_max, res=8, n_lobes=8)
    levels = tgrid.active_levels(grid0)
    guide = make_guide_fn(0.5, types_present(scene.mats), levels=levels)
    waves = chip_smoke.equal_spp_waves(scene, 48, 48, 4, guide, levels)
    ref = waves(grid0, 200, 96)[0]
    un = waves(grid0, 500, 8)[0]
    grid = waves(grid0, 0, 12, guided=True, fit=True)[1]
    g8 = waves(grid, 500, 8, guided=True)[0]
    r_u, r_g = chip_smoke.relmse(un, ref, trim=True), chip_smoke.relmse(g8, ref, trim=True)
    assert abs(g8.mean() - ref.mean()) / ref.mean() < 0.05
    assert r_g < 0.75 * r_u, (r_g, r_u)


@pytest.mark.slow
def test_door_room_guiding_gain_equal_spp():
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    scene = build_scene(door_room(60_000), device="cpu")
    levels = tgrid.MAX_REFINE_LEVELS
    guide = make_guide_fn(0.5, types_present(scene.mats), levels=levels, min_rough=0.3)
    waves = chip_smoke.equal_spp_waves(scene, 96, 96, 5, guide, levels, accel="bvh")
    grid = grid0 = tgrid.make_grid(scene.aabb_min, scene.aabb_max, res=16, n_lobes=8,
                                   capacity=4 * 16**3)
    ref = waves(grid0, 200, 24)[0]
    un = waves(grid0, 600, 4)[0]
    for prog in range(3):
        grid = waves(grid, prog * 8, 8, guided=True, fit=True)[1]
        if prog < 2:
            grid = refine_grid(grid, 256.0)
    assert grid.n_used > 16**3
    g = waves(grid, 600, 4, guided=True)[0]
    r_u, r_g = chip_smoke.relmse(un, ref), chip_smoke.relmse(g, ref)
    gain = r_u / max(r_g, 1e-9)
    assert gain > 1.10, (r_u, r_g, gain)
