"""The port's scene compiler and pinhole camera agree with the JAX package:
the same scene description compiles to equal arrays (the coats and the HK
slab with their transmittance tables, the sun and sky emitters and every
sensor kind included), and primary rays agree within 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.convert import scene_from_numpy
from mitsuba_path_guiding_torch.core import rng as trng
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import to_numpy_tree


def _compare(port, ref, path):
    """Every field the port fills equals the reference's, recursively; the
    port's own layouts (``PORT_ONLY``, the BVH's packed walk) have no
    reference counterpart."""
    if port is None:
        return
    if hasattr(port, "_fields"):
        for f in port._fields:
            if f not in getattr(port, "PORT_ONLY", ()):
                _compare(getattr(port, f), getattr(ref, f), f"{path}.{f}")
        return
    if isinstance(port, (bool, int, float)):
        assert port == ref, path
        return
    want = np.asarray(ref)
    got = port.cpu().numpy()
    assert got.shape == want.shape, (path, got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=path)


def _tallbox(mod, bsdf):
    sc = mod.cornell_box()
    sc["shapes"][5]["bsdf"] = bsdf
    return sc


def _sunsky(etype, **kw):
    return lambda m: {"sensor": {"type": "perspective", "fov": 60.0},
                      "shapes": [{"type": "rectangle", "bsdf": {"type": "diffuse"}}],
                      "emitters": [{"type": etype, "elevation": 35.0, "azimuth": 180.0,
                                    "turbidity": 3.0, **kw}]}


def _sensor(**kw):
    def make(m):
        sc = m.cornell_box()
        sc["sensor"] = {**sc["sensor"], **kw}
        return sc
    return make


def _sss_slab(m, sigma_a=(0.02, 0.04, 0.1)):
    """tests/test_subsurface.py's translucent slab: a dipole cube between
    a point light and the camera."""
    return {"sensor": {"type": "perspective", "fov": 50.0,
                       "to_world": m.look_at([0, 0, -3], [0, 0, 0])},
            "shapes": [{"type": "cube",
                        "to_world": m.translate(0, 0, 0) @ np.diag([1.0, 1.0, 0.12, 1.0]),
                        "bsdf": {"type": "diffuse", "reflectance": [0.0] * 3},
                        "subsurface": {"sigma_a": list(sigma_a),
                                       "sigma_s": [1.2, 1.0, 0.8], "eta": 1.3}}],
            "emitters": [{"type": "point", "position": [0.0, 0.0, 1.5],
                          "intensity": [8.0, 8.0, 8.0]}]}


def _sss_mixed(m):
    """Cornell with a single-scattering short box (g, raw sigma_s) and a
    dipole tall box given by int_ior/ext_ior, scale and the defaults."""
    sc = m.cornell_box()
    sc["shapes"][5]["subsurface"] = {"type": "dipole", "int_ior": 1.45, "ext_ior": 1.05,
                                     "scale": 2.0, "g": 0.3}
    sc["shapes"][6]["subsurface"] = {"type": "singlescatter", "sigma_a": 0.05,
                                     "sigma_s": [0.8, 0.6, 0.4], "eta": 1.33, "g": 0.8}
    return sc


RECIPES = {
    "sss_slab": _sss_slab,
    "sss_mixed": _sss_mixed,
    "cornell_box": lambda m: m.cornell_box(),
    "bounce_lamp_room": lambda m: m.bounce_lamp_room(),
    "veach_mis": lambda m: m.veach_mis(),
    "furnace": lambda m: m.furnace(),
    "cornell_glass": lambda m: m.cornell_box(box_material="glass"),
    "cornell_mirror": lambda m: m.cornell_box(box_material="mirror"),
    "cornell_mask": lambda m: _tallbox(m, {"type": "mask", "opacity": [0.0] * 3,
                                           "bsdf": {"type": "diffuse"}}),
    "cornell_blend": lambda m: _tallbox(m, {
        "type": "blendbsdf", "weight": 0.4,
        "bsdfs": [{"type": "diffuse", "reflectance": [0.7, 0.2, 0.2]},
                  {"type": "roughconductor", "material": "Au", "alpha": 0.2}]}),
    "cornell_coating": lambda m: _tallbox(m, {"type": "coating", "sigma_a": 0.3,
                                              "bsdf": {"type": "roughplastic", "alpha": 0.2}}),
    "cornell_roughcoating": lambda m: _tallbox(m, {"type": "roughcoating", "alpha": 0.25,
                                                   "int_ior": 1.7, "thickness": 0.3}),
    "cornell_hk": lambda m: _tallbox(m, {"type": "hk", "sigma_t": [2.0, 1.0, 0.5],
                                         "albedo": 0.7, "g": -0.2}),
    "sky": _sunsky("sky"),
    "sun": _sunsky("sun", sun_scale=2.0),
    "sunsky": _sunsky("sunsky"),
    "sunsky_preetham": _sunsky("sunsky", model="preetham", sun_direction=[0.2, 1.0, -0.4],
                               resolution=32, scale=0.5),
    "thinlens": _sensor(type="thinlens", aperture_radius=0.1, focus_distance=3.7),
    "perspective_rdist": _sensor(type="perspective_rdist", kc=[0.1, 0.02]),
    "orthographic": _sensor(type="orthographic", ortho_width=1.2),
    "spherical": _sensor(type="spherical"),
    "telecentric": _sensor(type="telecentric", ortho_width=1.0, aperture_radius=0.05),
    "irradiancemeter": _sensor(type="irradiancemeter"),
    "radiancemeter": _sensor(type="radiancemeter"),
    "fluencemeter": _sensor(type="fluencemeter"),
}


@pytest.mark.parametrize("name", list(RECIPES))
def test_scene_compiles_to_equal_arrays(name):
    ref = j_build_scene(RECIPES[name](jscenes))
    port = build_scene(RECIPES[name](tscenes), device="cpu")
    assert port.bvh is not None and port.pairs is None and port.blocks is None
    assert (port.sss_packed is None) == (ref.sss_packed is None)
    _compare(port, ref, name)
    if name.startswith("sss_"):
        # the subsurface rows and each triangle's row, bit for bit
        np.testing.assert_array_equal(port.sss_packed.numpy(), np.asarray(ref.sss_packed))
        np.testing.assert_array_equal(port.geo.shade_packed[:, 27].numpy(),
                                      np.asarray(ref.geo.shade_packed)[:, 27])
        assert (port.geo.shade_packed[:, 27] >= 0).any()


def test_scene_descriptions_are_copies():
    assert repr(tscenes.cornell_box()) == repr(jscenes.cornell_box())
    assert repr(tscenes.bounce_lamp_room()) == repr(jscenes.bounce_lamp_room())
    for box in ("glass", "mirror"):
        assert repr(tscenes.cornell_box(box_material=box)) == repr(
            jscenes.cornell_box(box_material=box))
    assert repr(tscenes.furnace()) == repr(jscenes.furnace())
    assert repr(tscenes.veach_mis()) == repr(jscenes.veach_mis())


def test_converted_scene_equals_compiled_scene():
    # nested material rows and the environment tables come across too
    for name in ("cornell_box", "cornell_blend", "cornell_mask", "furnace", "cornell_roughcoating",
                 "sunsky", "thinlens", "perspective_rdist", "fluencemeter"):
        ref = j_build_scene(RECIPES[name](jscenes))
        conv = scene_from_numpy(to_numpy_tree(ref), device="cpu")
        _compare(conv, ref, f"converted {name}")


@pytest.mark.parametrize("name,w,h", [("cornell_box", 32, 32), ("bounce_lamp_room", 48, 24)])
def test_generate_rays(name, w, h):
    ref = j_build_scene(getattr(jscenes, name)())
    port = build_scene(getattr(tscenes, name)(), device="cpu")
    pix = np.arange(w * h, dtype=np.int32)
    kj = jrng.ray_keys(jrng.base_key(2), jnp.asarray(pix), jnp.zeros_like(jnp.asarray(pix)))
    u = np.array(jrng.event_uniform(kj, jrng.TAG_CAMERA, 2))
    oj, dj, xyj = j_generate_rays(ref.sensor, w, h, jnp.asarray(pix), jnp.asarray(u))
    ot, dt, xyt = generate_rays(port.sensor, w, h, torch.from_numpy(pix).long(),
                                torch.from_numpy(u))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(xyt.numpy(), np.asarray(xyj), rtol=0, atol=1e-6)
    # and the port's own key stream gives the same camera uniforms
    kt = trng.ray_keys(trng.base_key(2), torch.from_numpy(pix), torch.zeros(w * h, dtype=torch.int64))
    np.testing.assert_array_equal(trng.event_uniform(kt, trng.TAG_CAMERA, 2).numpy(), u)


# a deformable plane sliding by 1 along x (tests/test_motion.py's)
_V0 = 0.35 * np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], float)
_FRAMES = {"vertices_frames": [_V0, _V0 + np.array([1.0, 0.0, 0.0])],
           "faces": np.array([[0, 1, 2], [0, 2, 3]])}
_CONSTANT = [{"type": "constant"}]


def _deformable(**kw):
    return {"type": "deformable", **_FRAMES, **kw}


def _compiles_like_jax(desc):
    ref = j_build_scene(desc)
    port = build_scene(desc, device="cpu")
    assert (port.sss_packed is None) == (ref.sss_packed is None)
    _compare(port, ref, "desc")


# Deformable shapes raised NotImplementedError until they were ported with
# the animation module; each combination now compiles equal to the JAX
# package's build (the ids are the cases' old ones).
@pytest.mark.parametrize("desc", [
    pytest.param({"shapes": [_deformable(bsdf={"type": "bumpmap"})], "emitters": _CONSTANT},
                 id="desc0-Queue 1 item 9"),
    pytest.param({"shapes": [_deformable(bsdf={"type": "diffuse",
                                               "texture": {"type": "checkerboard"}})],
                  "emitters": [{"type": "sunsky"}]}, id="desc1-Queue 1 item 9"),
    pytest.param({"shapes": [_deformable()], "emitters": _CONSTANT,
                  "medium": {"sigma_s": [1.0] * 3}}, id="desc2-Queue 1 item 9"),
])
def test_unported_features_raise(desc):
    _compiles_like_jax(desc)


@pytest.mark.parametrize("desc", [
    pytest.param({"shapes": [_deformable(bsdf={"type": "normalmap"},
                                         subsurface={"type": "dipole"})],
                  "emitters": _CONSTANT}, id="desc0-animation"),
    pytest.param({"shapes": [_deformable(bsdf={"type": "coating", "bsdf": {
        "type": "diffuse", "texture": {"type": "checkerboard"}}})], "emitters": _CONSTANT},
        id="desc1-loaders"),
    pytest.param({"shapes": [_deformable(subsurface={"type": "dipole"})], "emitters": _CONSTANT},
                 id="desc2-animation"),
    pytest.param({"shapes": [_deformable()], "emitters": [{"type": "sky"}],
                  "medium": {"sigma_s": [1.0] * 3}}, id="desc3-the loaders"),
    pytest.param({"shapes": [_deformable(bsdf={"type": "bumpmap", "bsdf": {"type": "hk"}})],
                  "emitters": _CONSTANT}, id="desc4-animation"),
    pytest.param({"shapes": [_deformable(subsurface={"type": "singlescatter"})],
                  "emitters": [{"type": "point", "position": [0.0, 0.0, -2.0]}]},
                 id="desc5-animation"),
    pytest.param({"shapes": [_deformable(subsurface={"type": "dipole"},
                                         bsdf={"type": "irawan"})], "emitters": _CONSTANT},
                 id="desc6-Queue 1 item 9"),
])
def test_next_slices_raise(desc):
    _compiles_like_jax(desc)


@pytest.mark.parametrize("desc", [
    {"shapes": [{"type": "rectangle", "bsdf": {"type": "mask", "bsdf": {"type": "coating"}}}],
     "emitters": [{"type": "constant"}]},
    {"shapes": [{"type": "rectangle"}], "emitters": [{"type": "sky"}, {"type": "sunsky"}]},
    {"shapes": [{"type": "rectangle", "bsdf": {"type": "velvet"}}]},
    {"shapes": [{"type": "rectangle"}], "emitters": [{"type": "laser"}]},
    {"shapes": [{"type": "rectangle", "bsdf": {"type": "mask", "bsdf": {"type": "mask"}}}],
     "emitters": [{"type": "constant"}]},
])
def test_unknown_or_nested_wrappers_are_refused(desc):
    with pytest.raises(ValueError):
        build_scene(desc, device="cpu")


def test_card_is_the_default_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_scene(tscenes.cornell_box())
