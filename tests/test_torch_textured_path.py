"""The port's path tracer on textured, bump-mapped, vertex-coloured,
wireframe and cloth scenes against the JAX package on the CPU: ``trace``
from the same keys (the reflectance override, the normal-map frame, the
yarn records and the ray-cone mip filtering), each lane's radiance within
rtol 1e-4 on >= 99% of lanes; the guided ProgressiveRenderer at 16x16, 2
progressions of 2 spp, per pixel rtol 1e-4 on >= 99% of pixels; the
render's texture flags and cone angle; and the fused kernel's gate, which
a textured, vertex-coloured or bump-mapped diffuse scene must fail."""
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import texture_descs
from mitsuba_path_guiding_torch.integrators import render as trender
from mitsuba_path_guiding_torch.integrators.path import trace
from mitsuba_path_guiding_torch.integrators.progressive import (
    ProgressiveConfig,
    ProgressiveRenderer,
)
from mitsuba_path_guiding_torch.models.bsdf import types_present
from mitsuba_path_guiding_torch.models.emitter import kinds_present
from mitsuba_path_guiding_torch.ops.fused_path import fused_supported
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.integrators import progressive as jprog
from mitsuba_path_guiding_tpu.integrators import render as jrender
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, t

_IMG = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)


def _everything(mod):
    """The Cornell box with one feature on each surface: a checkerboard
    floor, a normal-mapped ceiling, a bump-mapped rough-plastic back wall,
    an irawan left wall, a wireframe right wall and a curvature-coloured
    tall box."""
    sc = mod.cornell_box()
    sc["shapes"][0]["bsdf"] = {"type": "diffuse", "texture": {"type": "checkerboard",
                                                              "uscale": 4, "vscale": 4}}
    sc["shapes"][1]["bsdf"] = {"type": "normalmap", "bsdf": {"type": "diffuse"},
                               "texture": {"type": "bitmap", "image": _IMG}}
    sc["shapes"][2]["bsdf"] = {"type": "bumpmap", "scale": 0.5, "bsdf": {"type": "roughplastic"},
                               "texture": {"type": "gridtexture"}}
    sc["shapes"][3]["bsdf"] = {"type": "irawan", "repeatU": 4, "repeatV": 4}
    sc["shapes"][4]["bsdf"] = {"type": "diffuse", "texture": {"type": "wireframe",
                                                              "line_width": 0.1}}
    sc["shapes"][5]["bsdf"] = {"type": "diffuse", "texture": {"type": "curvature"}}
    return sc


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("textures"))
    jd, td = texture_descs(jscenes, d), texture_descs(tscenes, d)
    jd["everything"], td["everything"] = _everything(jscenes), _everything(tscenes)
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (j_build_scene(jd[name]), build_scene(td[name], device="cpu"))
        return cache[name]
    return get


def _wave(jscene, n=2048, w=32, h=32):
    pix = jnp.arange(n, dtype=jnp.int32) % (w * h)
    kj = jrng.ray_keys(jrng.base_key(0), pix, jnp.arange(n, dtype=jnp.int32) // (w * h))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o, d, _ = j_generate_rays(jscene.sensor, w, h, pix, u)
    return o, d, kj


# (scene, the port's route, cone angle): "everything" carries every
# feature; the JAX package traces with its dense oracle or, where the port
# takes the BVH, with its BVH
CASES = [("everything", "auto", 0.0), ("everything", "bvh", 0.0), ("everything", "auto", 0.03),
         ("cloth", "auto", 0.0), ("floor_cone", "auto", 0.02)]


@pytest.mark.parametrize("name,accel,cone", CASES)
def test_trace_matches_reference(built, name, accel, cone):
    jscene, scene = built(name)
    o, d, kj = _wave(jscene)
    mat_types, em_kinds = types_present(scene.mats), kinds_present(scene.emitters)
    flags = trender.texture_flags(scene)
    assert flags == {"textured": True, "bumped": jrender._has_bump(jscene),
                     "clothed": jrender._has_cloth(jscene)} and jrender._textured(jscene)
    Lj, auxj, _ = j_trace(jscene, o, d, kj, max_depth=5, rr_depth=3, use_bvh=accel == "bvh",
                          em_kinds=em_kinds, mat_types=mat_types, cone_angle=cone, **flags)
    Lt, auxt, _ = trace(scene, t(o), t(d), t(kj), max_depth=5, rr_depth=3, em_kinds=em_kinds,
                        mat_types=mat_types, accel=accel, cone_angle=cone, **flags)
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0.0
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99
    # the albedo AOV ignores the texture, as in the reference
    assert frac_close(auxt.albedo.numpy(), np.asarray(auxj.albedo), rtol=1e-6) >= 0.99
    assert frac_close(auxt.normal.numpy(), np.asarray(auxj.normal), rtol=1e-4) >= 0.99


@pytest.mark.parametrize("name", ["everything"])
def test_progressive_matches_reference(built, name):
    """JAX's and the port's guided ProgressiveRenderer at 16x16, 2
    progressions of 2 spp: the image per pixel rtol 1e-4 on >= 99% of
    pixels (the grids' fit follows the same records)."""
    jscene, scene = built(name)
    kw = dict(samples_per_progression=2, n_progressions=2, guiding=True, grid_res=4, n_lobes=8)
    jr = jprog.ProgressiveRenderer(jscene, jprog.ProgressiveConfig(
        render=jrender.RenderConfig(width=16, height=16, spp=0, max_depth=5), **kw))
    img_j = np.asarray(jr.render())
    pr = ProgressiveRenderer(scene, ProgressiveConfig(
        render=trender.RenderConfig(width=16, height=16, spp=0, max_depth=5), **kw))
    img_t = pr.render().numpy()
    assert img_j.mean() > 0.0 and int(pr.grid.valid.sum()) > 0
    assert frac_close(img_t.reshape(-1, 3), img_j.reshape(-1, 3), rtol=1e-4) >= 0.99


def test_cone_angle_and_flags_follow_the_reference(built):
    """On textured scenes the flags and the cone angle are the
    reference's.  A scene without a texture turns the override off (the
    reference runs it on every scene, to no effect: its placeholder atlas
    passes its shape test), and so has no cone angle."""
    for name in ("everything", "cloth", "floor_cone", "cornell_checker", "cornell_vcol_wire"):
        jscene, scene = built(name)
        cfg = trender.RenderConfig(width=24, height=24)
        assert trender._cone_angle(scene, cfg) == jrender._cone_angle(jscene, cfg), name
        assert trender._textured(scene) and jrender._textured(jscene), name
    jscene, scene = built("envmap_file")
    assert trender.texture_flags(scene) == {"textured": False, "bumped": False, "clothed": False}
    assert jrender._textured(jscene) and jrender._cone_angle(jscene, trender.RenderConfig()) > 0
    assert trender._cone_angle(scene, trender.RenderConfig()) == 0.0


@pytest.mark.parametrize("feature", ["checkerboard", "vertexcolors", "bumpmap", "wireframe",
                                     "none"])
def test_fused_gate_refuses_textured_diffuse_scenes(feature):
    """A diffuse Cornell box with a texture, vertex colours or a bump map
    on the floor fails the fused kernel's gate (the kernel would drop
    them); the untextured box passes it."""
    sc = tscenes.cornell_box()
    tex = {"checkerboard": {"type": "checkerboard"}, "vertexcolors": {"type": "vertexcolors"},
           "wireframe": {"type": "wireframe"}}
    if feature == "bumpmap":
        sc["shapes"][0]["bsdf"] = {"type": "bumpmap", "bsdf": {"type": "diffuse"},
                                   "texture": {"type": "gridtexture"}}
    elif feature in tex:
        sc["shapes"][0]["bsdf"] = {"type": "diffuse", "texture": tex[feature]}
    scene = build_scene(sc, device="cpu")
    assert set(types_present(scene.mats)) == {0}
    assert fused_supported(scene) == (feature == "none")


def test_render_wave_takes_the_wavefront_for_a_textured_scene(built, monkeypatch):
    """Unguided render_wave on the checkerboard box takes the wavefront
    (the trivial guide), with the texture flags and the cone angle."""
    _, scene = built("cornell_checker")
    seen = {}
    real = trender.trace

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(trender, "trace", spy)
    import torch

    cfg = trender.RenderConfig(width=8, height=8, spp=1, max_depth=2)
    pix = torch.arange(64)
    _, L, _ = trender.render_wave(scene, cfg, pix, torch.zeros_like(pix))
    assert seen["textured"] and not seen["bumped"] and not seen["clothed"]
    assert seen["cone_angle"] == pytest.approx(2.0 * float(scene.sensor.tan_half_fov_x) / 8)
    assert torch.isfinite(L).all()
