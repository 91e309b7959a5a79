"""The port's light-path integrators against the JAX package on the CPU:
``sample_ray`` for every emitter kind, ``eval_hit``, ``pdf_direct_hit`` and
``sample_direct``'s bidirectional extras; BDPT's light keys; ``trace_light``
and ``trace_bdpt`` lane by lane on 16x16 waves; ``generate_vpls``;
``render_ptracer``, ``render_bdpt`` (with and without the light image) and
``render_vpl`` at 16x16; the routes against each other; and twins of the
JAX package's slow cross-consistency tests (tests/test_bdpt.py,
tests/test_ptracer.py, tests/test_vpl_erpt.py), slow as theirs are.

Tolerances: per-lane fields rtol 1e-5 / atol 1e-6 (sample_ray), the wave
traces' flags equal on >= 99% of lanes and values within rtol 1e-4 / atol
1e-6 where both are set (tests/test_torch_volpath.py's bar: XLA on the CPU
contracts multiply-adds), images' means within 1e-3 relative and >= 99%
of pixels within 1e-3.  The JAX traces are shared through module-scoped
fixtures: each compiles once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.integrators import bdpt, ptracer, vpl
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.models import bsdf, emitter
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box
from mitsuba_path_guiding_torch.scene.transforms import look_at, rotate, scale, translate
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.integrators import bdpt as jbdpt
from mitsuba_path_guiding_tpu.integrators import ptracer as jptracer
from mitsuba_path_guiding_tpu.integrators import vpl as jvpl
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.models import bsdf as jbsdf
from mitsuba_path_guiding_tpu.models import emitter as jemitter
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, port_scene, t

N = 4096
W = H = 16
DEPTH = 3
IMG_RTOL = 1e-3


def _env_image(h=8, w=16, seed=3):
    img = np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)
    img[2, 5] = 40.0
    return img


def _spot(pos, target, cutoff=30.0):
    return {"type": "spot", "to_world": look_at(pos, target), "intensity": [5.0, 4.0, 3.0],
            "cutoff_angle": cutoff}


RAY_KINDS = {
    "area": [],
    "point": [{"type": "point", "position": [0.3, 1.5, -0.2], "intensity": [3.0, 2.0, 1.0]}],
    "spot": [_spot([0.0, 1.8, 0.0], [0.0, 0.0, 0.0])],
    "constant": [{"type": "constant", "radiance": [0.8, 0.9, 1.0]}],
    "directional": [{"type": "directional", "direction": [0.2, -1.0, 0.3],
                     "irradiance": [2.0, 2.0, 2.0]}],
    "envmap": [{"type": "envmap", "image": _env_image(), "scale": 1.5}],
    "collimated": [{"type": "collimated", "position": [0, 1, 0], "direction": [0, -1, 0]}],
    "all": [{"type": "point", "position": [0.3, 1.5, -0.2]}, _spot([1.0, 1.8, 0.0], [0, 0, 0]),
            {"type": "directional", "direction": [0.0, -1.0, 0.0]},
            {"type": "envmap", "image": _env_image()}],
}


def _emitter_desc(emitters, area=True):
    shapes = [{"type": "rectangle", "to_world": np.diag([2.0, 2.0, 1.0, 1.0]),
               "bsdf": {"type": "diffuse"}}]
    if area:
        shapes.append({"type": "rectangle", "to_world": np.array(
            [[0.3, 0, 0, 0], [0, 0, 0.3, 2.0], [0, -0.3, 0, 0], [0, 0, 0, 1]], dtype=float),
            "emitter": {"radiance": [4.0, 4.0, 4.0]}})
    return {"shapes": shapes, "emitters": emitters}


def cornell_point_desc(mod):
    """The JAX package's point-light Cornell box (tests/test_bdpt.py)."""
    sc = mod.cornell_box()
    sc["shapes"] = [s for s in sc["shapes"] if not s.get("emitter")]
    sc["emitters"] = [{"type": "point", "position": [0.0, 0.9, 0.0],
                       "intensity": [1.0, 0.9, 0.7]}]
    return sc


def env_desc():
    """tests/test_bdpt.py's open scene under a constant environment."""
    white = {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]}
    return {
        "shapes": [
            {"type": "rectangle", "to_world": rotate([1, 0, 0], -90) @ scale(3.0), "bsdf": white},
            {"type": "cube", "to_world": translate(0, 0.5, 0) @ scale(0.5),
             "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.3, 0.2]}},
        ],
        "emitters": [{"type": "constant", "radiance": [0.8, 0.9, 1.0]}],
        "sensor": {"type": "perspective", "fov": 50.0,
                   "to_world": look_at([2.5, 2.0, -2.5], [0, 0.4, 0], [0, 1, 0])},
    }


SCENES = {"cornell": lambda: jscenes.cornell_box(), "cornell_point": lambda: cornell_point_desc(
    jscenes), "env": env_desc}


class _Case:
    """One scene in both packages with a 16x16 wave of keys."""

    def __init__(self, desc):
        self.jscene = j_build_scene(desc)
        self.scene = port_scene(self.jscene)
        self.pix = jnp.arange(W * H, dtype=jnp.int32)
        self.kj = jrng.ray_keys(jrng.base_key(0), self.pix, jnp.zeros_like(self.pix))
        self.kt = t(self.kj)
        self.em_kinds = jemitter.kinds_present(self.jscene.emitters)
        self.mat_types = jbsdf.types_present(self.jscene.mats)
        self.port_types = bsdf.types_present(self.scene.mats)


@pytest.fixture(scope="module")
def cases():
    return {name: _Case(desc()) for name, desc in SCENES.items()}


def _assert_splats(got, want):
    """Light splats lane by lane: ok flags equal on >= 99% of lanes, film
    coordinates and values close where both are set."""
    xy, rgb, ok = (x.numpy() for x in got)
    jxy, jrgb, jok = (np.asarray(x) for x in want)
    assert ok.shape == jok.shape
    assert (ok == jok).mean() >= 0.99
    both = ok & jok
    assert both.sum() > 0
    assert frac_close(xy[both], jxy[both], rtol=1e-4) >= 0.99
    assert frac_close(np.moveaxis(rgb, 1, 2)[both], np.moveaxis(jrgb, 1, 2)[both],
                      rtol=1e-4) >= 0.99


# ---- the emitter-ray sampler and the bidirectional extras

@pytest.mark.parametrize("kind", sorted(RAY_KINDS))
def test_sample_ray_matches(kind):
    desc = _emitter_desc(RAY_KINDS[kind], area=kind in ("area", "all"))
    jscene = j_build_scene(desc)
    scene = build_scene(desc, device="cpu")
    u = np.random.default_rng(len(kind)).random((N, 5)).astype(np.float32)
    kinds = emitter.kinds_present(scene.emitters)
    assert kinds == jemitter.kinds_present(jscene.emitters)
    got = emitter.sample_ray(scene.emitters, scene.aabb_min, scene.aabb_max,
                             torch.from_numpy(u), kinds=kinds)
    want = jemitter.sample_ray(jscene.emitters, jscene.aabb_min, jscene.aabb_max,
                               jnp.asarray(u), kinds=kinds)
    for f in ("valid", "infinite"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), f)
    assert got.valid.numpy().mean() > 0.5
    for f in ("o", "d", "weight", "normal", "emit_weight", "emission_pdf_w", "direct_pdf_a",
              "cos_light"):
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        assert frac_close(a, b, rtol=1e-5, atol=1e-6) >= 0.999, f


def test_scene_radius_is_the_references():
    jscene = j_build_scene(jscenes.cornell_box())
    scene = port_scene(jscene)
    want = 0.5 * jnp.linalg.norm(jscene.aabb_max - jscene.aabb_min) + 1e-3
    got = emitter.scene_radius(scene.aabb_min, scene.aabb_max)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("kind", ["area", "point", "spot", "all"])
def test_sample_direct_vcm_extras(kind):
    desc = _emitter_desc(RAY_KINDS[kind], area=kind in ("area", "all"))
    jscene = j_build_scene(desc)
    scene = build_scene(desc, device="cpu")
    rs = np.random.default_rng(7 + len(kind))
    p = (rs.random((N, 3)) * [2.0, 1.0, 2.0] - [1.0, 0.0, 1.0]).astype(np.float32)
    u = rs.random((N, 3)).astype(np.float32)
    kinds = emitter.kinds_present(scene.emitters)
    ds = emitter.sample_direct(scene.emitters, scene.geo, torch.from_numpy(p),
                               torch.from_numpy(u), kinds=kinds, vcm=True)
    dj = jemitter.sample_direct(jscene.emitters, jscene.geo, jnp.asarray(p), jnp.asarray(u),
                                kinds=kinds)
    for f in ("cos_light", "emission_pdf_w"):
        assert frac_close(getattr(ds, f).numpy(), np.asarray(getattr(dj, f)),
                          rtol=1e-5) >= 0.999, f
    # the path tracers' call computes none of them, and the rest is unchanged
    plain = emitter.sample_direct(scene.emitters, scene.geo, torch.from_numpy(p),
                                  torch.from_numpy(u), kinds=kinds)
    assert plain.cos_light is None and plain.emission_pdf_w is None
    for f in ("direction", "distance", "radiance", "pdf", "is_delta", "emitter_id"):
        assert torch.equal(getattr(plain, f), getattr(ds, f)), f


def test_eval_hit_and_pdf_direct_hit():
    jscene = j_build_scene(jscenes.cornell_box())
    scene = port_scene(jscene)
    rs = np.random.default_rng(11)
    n_tri, n_em = scene.geo.p0.shape[0], scene.emitters.kind.shape[0]
    prim = rs.integers(0, n_tri, N).astype(np.int32)
    eid = rs.integers(-1, n_em, N).astype(np.int32)
    wo = rs.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    p = rs.random((N, 3)).astype(np.float32)
    q = rs.random((N, 3)).astype(np.float32)
    got = emitter.eval_hit(scene.emitters, scene.geo, torch.from_numpy(eid),
                           torch.from_numpy(wo), torch.from_numpy(prim).long())
    want = jemitter.eval_hit(jscene.emitters, jscene.geo, jnp.asarray(eid), jnp.asarray(wo),
                             jnp.asarray(prim))
    assert frac_close(got.numpy(), np.asarray(want), rtol=1e-5) >= 0.999
    assert (got.numpy().max(-1) > 0).any()
    got = emitter.pdf_direct_hit(scene.emitters, scene.geo, torch.from_numpy(eid),
                                 torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(wo))
    want = jemitter.pdf_direct_hit(jscene.emitters, jscene.geo, jnp.asarray(eid),
                                   jnp.asarray(p), jnp.asarray(q), jnp.asarray(wo))
    assert frac_close(got.numpy(), np.asarray(want), rtol=1e-5) >= 0.999


def test_light_keys_bit_equal(cases):
    c = cases["cornell"]
    want = jax.vmap(jax.random.fold_in, in_axes=(0, None))(c.kj, jbdpt.TAG_LIGHT_STREAM)
    got = rng.fold_in(c.kt, bdpt.TAG_LIGHT_STREAM)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


# ---- the wave traces, lane by lane

@pytest.mark.parametrize("name", ["cornell", "cornell_point"])
def test_trace_light_matches(cases, name):
    c = cases[name]
    want = jptracer.trace_light(c.jscene, c.kj, W, H, max_depth=DEPTH, rr_depth=2,
                                use_bvh=False, em_kinds=c.em_kinds, mat_types=c.mat_types)
    got = ptracer.trace_light(c.scene, c.kt, W, H, max_depth=DEPTH, rr_depth=2,
                              em_kinds=c.em_kinds, mat_types=c.port_types)
    assert got[2].shape == (DEPTH + 1, W * H)
    _assert_splats(got, want)


@pytest.fixture(scope="module")
def bdpt_waves(cases):
    out = {}
    for name, c in cases.items():
        out[name] = jbdpt.trace_bdpt(c.jscene, c.kj, c.pix, W, H, max_depth=DEPTH, use_bvh=False,
                                     em_kinds=c.em_kinds, mat_types=c.mat_types)
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_bdpt_matches(cases, bdpt_waves, name):
    c = cases[name]
    L, splats, n_seg = bdpt.trace_bdpt(c.scene, c.kt, t(c.pix).long(), W, H, max_depth=DEPTH,
                                       em_kinds=c.em_kinds, mat_types=c.port_types)
    jL, jsplats, jn_seg = bdpt_waves[name]
    assert int(n_seg) == int(jn_seg)
    assert frac_close(L.numpy(), np.asarray(jL), rtol=1e-4) >= 0.99
    assert float(L.mean()) > 0.0
    _assert_splats(splats, jsplats)


@pytest.mark.parametrize("accel", ["bvh", "brute"])
def test_routes_trace_the_same_waves(cases, accel):
    """The BVH and the dense oracle give the tiled route's results (the
    tiled kernel has the oracle's winner; the BVH's ties may differ on a
    few lanes)."""
    c = cases["cornell"]
    kw = dict(max_depth=DEPTH, em_kinds=c.em_kinds, mat_types=c.port_types)
    pix = t(c.pix).long()
    L, splats, _ = bdpt.trace_bdpt(c.scene, c.kt, pix, W, H, **kw)
    L2, splats2, _ = bdpt.trace_bdpt(c.scene, c.kt, pix, W, H, accel=accel, **kw)
    assert frac_close(L2.numpy(), L.numpy(), rtol=1e-5) >= 0.99
    assert (splats2[2] == splats[2]).float().mean() >= 0.99
    got = ptracer.trace_light(c.scene, c.kt, W, H, accel=accel, **kw)
    want = ptracer.trace_light(c.scene, c.kt, W, H, **kw)
    assert (got[2] == want[2]).float().mean() >= 0.99


def test_generate_vpls_matches(cases):
    c = cases["cornell"]
    want = jvpl.generate_vpls(c.jscene, 256, seed=1, max_depth=DEPTH, use_bvh=False,
                              em_kinds=c.em_kinds, mat_types=c.mat_types)
    got = vpl.generate_vpls(c.scene, 256, seed=1, max_depth=DEPTH, em_kinds=c.em_kinds,
                            mat_types=c.port_types)
    valid, jvalid = got.valid.numpy(), np.asarray(want.valid)
    assert valid.shape == ((DEPTH + 1) * 256,)
    assert (valid == jvalid).mean() >= 0.99
    np.testing.assert_array_equal(got.mid.numpy()[valid & jvalid],
                                  np.asarray(want.mid)[valid & jvalid])
    both = valid & jvalid
    for f in ("pos", "normal", "wi", "flux"):
        assert frac_close(getattr(got, f).numpy()[both], np.asarray(getattr(want, f))[both],
                          rtol=1e-4) >= 0.99, f


# ---- the renders

def _assert_image(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert float(want.mean()) > 0.0
    assert abs(float(got.mean()) / float(want.mean()) - 1.0) < IMG_RTOL
    assert frac_close(got, want, rtol=IMG_RTOL, atol=1e-6) >= 0.99


def _cfgs(spp, depth=DEPTH, seed=2):
    return (RenderConfig(width=W, height=H, spp=spp, max_depth=depth, rr_depth=2, seed=seed),
            JRenderConfig(width=W, height=H, spp=spp, max_depth=depth, rr_depth=2, seed=seed,
                          use_bvh=False))


def test_render_ptracer_matches(cases):
    c = cases["cornell"]
    cfg, jcfg = _cfgs(2)
    # two waves of 256 particles: the wave index enters the keys
    img = ptracer.render_ptracer(c.scene, cfg._replace(pixel_batch=256))
    _assert_image(img, jptracer.render_ptracer(c.jscene, jcfg._replace(pixel_batch=256)))


@pytest.mark.parametrize("light_image", [True, False])
def test_render_bdpt_matches(cases, light_image):
    c = cases["cornell"]
    cfg, jcfg = _cfgs(2)
    img = bdpt.render_bdpt(c.scene, cfg, light_image=light_image)
    _assert_image(img, jbdpt.render_bdpt(c.jscene, jcfg, light_image=light_image))


def test_render_vpl_matches(cases, monkeypatch):
    """64 VPL paths at depth 4 (192 VPLs) in the reference's chunks of 16,
    the port's queries 4096 lanes (16 VPLs) and 32768 lanes (128 VPLs)
    wide: the same sums in the same order."""
    c = cases["cornell"]
    cfg, jcfg = _cfgs(1, depth=4)
    want = jvpl.render_vpl(c.jscene, jcfg, n_vpl_paths=64, vpl_chunk=16)
    for lanes in (16 * W * H, 128 * W * H):
        monkeypatch.setattr(vpl, "CHUNK_LANES", lanes)
        _assert_image(vpl.render_vpl(c.scene, cfg, n_vpl_paths=64, vpl_chunk=16), want)


def test_vpl_chunking_keeps_the_order(monkeypatch):
    """Chunks smaller and larger than the reference's block add the same
    sums: the images are bit-equal."""
    scene = build_scene(cornell_box(), device="cpu")
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=4, seed=4)
    imgs = []
    for c in (1, 8, 32, 96):
        monkeypatch.setattr(vpl, "CHUNK_LANES", c * 64)
        imgs.append(vpl.render_vpl(scene, cfg, n_vpl_paths=48, vpl_chunk=32))
    for img in imgs[1:]:
        assert torch.equal(img, imgs[0])


# ---- twins of the JAX package's slow cross-consistency tests

@pytest.fixture(scope="module")
def cornell():
    return build_scene(cornell_box(), device="cpu")


@pytest.fixture(scope="module")
def cornell_point():
    from mitsuba_path_guiding_torch.scene import scenes

    return build_scene(cornell_point_desc(scenes), device="cpu")


@pytest.mark.slow
def test_bdpt_matches_pt_area_light(cornell):
    img_pt = render(cornell, RenderConfig(width=20, height=20, spp=256, max_depth=5, seed=3))
    img_b = bdpt.render_bdpt(cornell, RenderConfig(width=20, height=20, spp=96, max_depth=5,
                                                   seed=5))
    ratio = float(img_b.mean() / img_pt.mean())
    assert abs(ratio - 1.0) < 0.03, ratio
    rel = float((img_b - img_pt).abs().mean() / img_pt.mean())
    assert rel < 0.12, rel


@pytest.mark.slow
@pytest.mark.parametrize("depth,bar", [(2, 0.03), (5, 0.035)])
def test_bdpt_matches_pt_point_light(cornell_point, depth, bar):
    img_pt = render(cornell_point, RenderConfig(width=20, height=20, spp=192, max_depth=depth,
                                                seed=3))
    img_b = bdpt.render_bdpt(cornell_point, RenderConfig(width=20, height=20, spp=96,
                                                         max_depth=depth, seed=5))
    ratio = float(img_b.mean() / img_pt.mean())
    assert abs(ratio - 1.0) < bar, ratio


@pytest.mark.slow
def test_bdpt_light_image_carries_energy(cornell):
    cfg = RenderConfig(width=16, height=16, spp=64, max_depth=5, seed=7)
    full = float(bdpt.render_bdpt(cornell, cfg).mean())
    no_li = float(bdpt.render_bdpt(cornell, cfg, light_image=False).mean())
    assert no_li < full * 0.995


@pytest.mark.slow
def test_bdpt_matches_pt_constant_env():
    scene = build_scene(env_desc(), device="cpu")
    img_pt = render(scene, RenderConfig(width=20, height=20, spp=192, max_depth=4, seed=3))
    img_b = bdpt.render_bdpt(scene, RenderConfig(width=20, height=20, spp=96, max_depth=4,
                                                 seed=5))
    ratio = float(img_b.mean() / img_pt.mean())
    assert abs(ratio - 1.0) < 0.04, ratio
    rel = float((img_b - img_pt).abs().mean() / img_pt.mean())
    assert rel < 0.15, rel


def _floor_desc(emitters, area_light):
    shapes = [{"type": "rectangle", "to_world": rotate([1, 0, 0], -90) @ scale(2.0),
               "bsdf": {"type": "diffuse", "reflectance": [0.6] * 3}}]
    if area_light:
        shapes.append({"type": "rectangle",
                       "to_world": translate(0, 3, 0) @ rotate([1, 0, 0], 90) @ scale(0.4),
                       "bsdf": {"type": "diffuse", "reflectance": [0, 0, 0]},
                       "emitter": {"radiance": [30.0] * 3}})
    return {"sensor": {"type": "perspective", "fov": 45.0,
                       "to_world": look_at([0, 2, -4], [0, 0, 0])},
            "shapes": shapes, "emitters": emitters}


@pytest.mark.slow
def test_ptracer_matches_forward_direct():
    scene = build_scene(_floor_desc([], True), device="cpu")
    cfg = RenderConfig(width=24, height=24, spp=128, max_depth=2, seed=1)
    f, l_img = render(scene, cfg), ptracer.render_ptracer(scene, cfg)
    assert torch.isfinite(l_img).all()
    np.testing.assert_allclose(float(l_img.mean()), float(f.mean()), rtol=0.05)


@pytest.mark.slow
def test_ptracer_matches_forward_cornell(cornell):
    cfg = RenderConfig(width=24, height=24, spp=160, max_depth=6, seed=0)
    f, l_img = render(cornell, cfg).numpy(), ptracer.render_ptracer(cornell, cfg).numpy()
    np.testing.assert_allclose(l_img.mean(), f.mean(), rtol=0.08)
    corr = np.corrcoef(f.mean(-1).ravel(), l_img.mean(-1).ravel())[0, 1]
    assert corr > 0.97, corr


@pytest.mark.slow
def test_ptracer_point_light():
    scene = build_scene(_floor_desc([{"type": "point", "position": [0, 2.5, 0],
                                      "intensity": [8.0] * 3}], False), device="cpu")
    f = render(scene, RenderConfig(width=24, height=24, spp=64, max_depth=2, seed=2))
    l_img = ptracer.render_ptracer(scene, RenderConfig(width=24, height=24, spp=256,
                                                       max_depth=2, seed=2))
    np.testing.assert_allclose(float(l_img.mean()), float(f.mean()), rtol=0.06)


@pytest.mark.slow
def test_vpl_matches_pt_diffuse(cornell):
    img_pt = render(cornell, RenderConfig(width=16, height=16, spp=256, max_depth=3, seed=3))
    img_v = vpl.render_vpl(cornell, RenderConfig(width=16, height=16, spp=4, max_depth=3, seed=5),
                           n_vpl_paths=1024, clamp_dist=0.02)
    ratio = float(img_v.mean() / img_pt.mean())
    assert 0.85 < ratio < 1.05, ratio
    rel = float((img_v - img_pt).abs().mean() / img_pt.mean())
    assert rel < 0.25, rel


@pytest.mark.slow
def test_vpl_generation_shapes(cornell):
    vpls = vpl.generate_vpls(cornell, n_paths=64, seed=0, max_depth=3)
    v = int(vpls.pos.shape[0])
    assert vpls.flux.shape == (v, 3)
    assert bool(vpls.valid.any())
    assert bool((vpls.mid == -1).any())
