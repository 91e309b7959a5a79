"""The port's emitters against the JAX package on the CPU: ``sample_direct``
for every kind from the same shading points and uniforms, the environment
map's tables, lookups and sampling, and a twin of the JAX package's
point-light inverse-square check."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.models import emitter, envmap
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.transforms import look_at
from mitsuba_path_guiding_torch.scene.types import EmitterKind
from mitsuba_path_guiding_tpu.models import emitter as jemitter
from mitsuba_path_guiding_tpu.models import envmap as jenvmap
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, port_scene

N = 4096


def _env_image(h=8, w=16, seed=3):
    rs = np.random.default_rng(seed)
    img = rs.random((h, w, 3)).astype(np.float32)
    img[2, 5] = 40.0  # a bright texel, as a sun in a sky map
    return img


def _spot(pos, target, cutoff=30.0):
    # the spot's +z axis aims at the target
    return {"type": "spot", "to_world": look_at(pos, target), "intensity": [5.0, 4.0, 3.0],
            "cutoff_angle": cutoff}


KINDS = {
    "point": [{"type": "point", "position": [0.3, 1.5, -0.2], "intensity": [3.0, 2.0, 1.0]}],
    "spot": [_spot([0.0, 1.8, 0.0], [0.0, 0.0, 0.0])],
    "constant": [{"type": "constant", "radiance": [0.8, 0.9, 1.0]}],
    "directional": [{"type": "directional", "direction": [0.2, -1.0, 0.3],
                     "irradiance": [2.0, 2.0, 2.0]}],
    "envmap": [{"type": "envmap", "image": _env_image(), "scale": 1.5}],
    "collimated": [{"type": "collimated", "position": [0, 1, 0], "direction": [0, -1, 0]}],
    "all": [{"type": "point", "position": [0.3, 1.5, -0.2]}, _spot([1.0, 1.8, 0.0], [0.0, 0.0, 0.0]),
            {"type": "directional", "direction": [0.0, -1.0, 0.0]},
            {"type": "envmap", "image": _env_image()}],
}


def _desc(emitters, area=True):
    shapes = [{"type": "rectangle", "to_world": np.diag([2.0, 2.0, 1.0, 1.0]),
               "bsdf": {"type": "diffuse"}}]
    if area:
        shapes.append({"type": "rectangle", "to_world": np.array(
            [[0.3, 0, 0, 0], [0, 0, 0.3, 2.0], [0, -0.3, 0, 0], [0, 0, 0, 1]], dtype=float),
            "emitter": {"radiance": [4.0, 4.0, 4.0]}})
    return {"shapes": shapes, "emitters": emitters}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sample_direct_matches(kind):
    desc = _desc(KINDS[kind], area=kind != "collimated")
    jscene = j_build_scene(desc)
    scene = build_scene(desc, device="cpu")
    rs = np.random.default_rng(len(kind))
    p = (rs.random((N, 3)) * [2.0, 1.0, 2.0] - [1.0, 0.0, 1.0]).astype(np.float32)
    u = rs.random((N, 3)).astype(np.float32)
    kinds = emitter.kinds_present(scene.emitters)
    assert kinds == jemitter.kinds_present(jscene.emitters)
    ds = emitter.sample_direct(scene.emitters, scene.geo, torch.from_numpy(p),
                               torch.from_numpy(u), kinds=kinds)
    dj = jemitter.sample_direct(jscene.emitters, jscene.geo, jnp.asarray(p), jnp.asarray(u),
                                kinds=kinds)
    np.testing.assert_array_equal(ds.emitter_id.numpy(), np.asarray(dj.emitter_id))
    np.testing.assert_array_equal(ds.is_delta.numpy(), np.asarray(dj.is_delta))
    for f in ("direction", "distance", "radiance", "pdf"):
        assert frac_close(getattr(ds, f).numpy(), np.asarray(getattr(dj, f)), rtol=1e-5) >= 0.999, f
    if kind != "collimated":
        assert (ds.radiance.numpy().max(axis=-1) > 0).mean() > 0.1


def test_env_tables_match():
    img = _env_image()
    got, want = envmap.build_env_tables(img, 2.0), jenvmap.build_env_tables(img, 2.0)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    for k, v in envmap.constant_env_tables([0.5, 0.6, 0.7]).items():
        np.testing.assert_array_equal(v, np.asarray(jenvmap.constant_env_tables([0.5, 0.6, 0.7])[k]))


@pytest.fixture(scope="module")
def env_scene():
    desc = _desc(KINDS["envmap"])
    return j_build_scene(desc), build_scene(desc, device="cpu")


def test_env_lookups_match(env_scene):
    jscene, scene = env_scene
    rs = np.random.default_rng(5)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    u, v = envmap.dir_to_uv(torch.from_numpy(d))
    uj, vj = jenvmap.dir_to_uv(jnp.asarray(d))
    assert frac_close(u.numpy(), np.asarray(uj), rtol=1e-5) >= 0.999
    assert frac_close(v.numpy(), np.asarray(vj), rtol=1e-5) >= 0.999
    np.testing.assert_allclose(envmap.uv_to_dir(u, v).numpy(), d, atol=2e-5)
    em, jem = scene.emitters, jscene.emitters
    kinds = (EmitterKind.AREA, EmitterKind.ENVMAP)
    # texel lookups agree but for directions on a texel border
    assert frac_close(envmap.env_eval(em, torch.from_numpy(d)).numpy(),
                      np.asarray(jenvmap.env_eval(jem, jnp.asarray(d))), rtol=0) >= 0.999
    assert frac_close(emitter.eval_env(em, torch.from_numpy(d), kinds).numpy(),
                      np.asarray(jemitter.eval_env(jem, jnp.asarray(d), kinds)), rtol=0) >= 0.999
    assert frac_close(envmap.env_pdf_dir(em, torch.from_numpy(d)).numpy(),
                      np.asarray(jenvmap.env_pdf_dir(jem, jnp.asarray(d))), rtol=1e-5) >= 0.999
    assert frac_close(emitter.pdf_env(em, torch.from_numpy(d), kinds).numpy(),
                      np.asarray(jemitter.pdf_env(jem, jnp.asarray(d), kinds)), rtol=1e-5) >= 0.999


def test_env_sample_matches(env_scene):
    jscene, scene = env_scene
    u2 = np.random.default_rng(6).random((N, 2)).astype(np.float32)
    d, pdf, rad = envmap.env_sample(scene.emitters, torch.from_numpy(u2))
    dj, pdfj, radj = jenvmap.env_sample(jscene.emitters, jnp.asarray(u2))
    assert frac_close(d.numpy(), np.asarray(dj), rtol=1e-5) >= 0.999
    assert frac_close(pdf.numpy(), np.asarray(pdfj), rtol=1e-5) >= 0.999
    np.testing.assert_array_equal(rad.numpy(), np.asarray(radj))
    # the sampled density is the one env_pdf_dir reports
    np.testing.assert_allclose(envmap.env_pdf_dir(scene.emitters, d).numpy(), pdf.numpy(),
                               rtol=2e-3)
    # the bright texel draws its share
    assert (pdf.numpy() > 10 * np.median(pdf.numpy())).mean() > 0.05


def test_converted_env_scene_equals_compiled(env_scene):
    jscene, scene = env_scene
    conv = port_scene(jscene)
    for f in ("packed", "env_image", "env_cdf_rows", "env_cdf_cols", "env_pdf_tex", "env_pdf",
              "env_radiance"):
        np.testing.assert_array_equal(getattr(conv.emitters, f).numpy(),
                                      getattr(scene.emitters, f).numpy(), err_msg=f)


def test_point_light_inverse_square():
    """Direct radiance of a diffuse floor under a point light: the pixel
    below the light sees I / r^2 * cos * rho / pi (the JAX package's check
    reads it with a radiance meter; here a pinhole of 0.5 degrees looks
    straight down from 1 unit, so the pixels span 0.0044 units of floor)."""
    desc = {
        "shapes": [{"type": "rectangle", "to_world": np.diag([10.0, 10.0, 1.0, 1.0]),
                    "bsdf": {"type": "diffuse", "reflectance": [1.0, 1.0, 1.0]}}],
        "emitters": [{"type": "point", "position": [0.0, 0.0, 2.0],
                      "intensity": [1.0, 1.0, 1.0]}],
        "sensor": {"type": "perspective", "fov": 0.5,
                   "to_world": look_at([0, 0.0, 1.0], [0, 0, 0])},
    }
    scene = build_scene(desc, device="cpu")
    img = render(scene, RenderConfig(width=2, height=2, spp=256, max_depth=2, seed=5)).numpy()
    expect = 1.0 / (np.pi * 4.0)  # I / r^2 * cos(0) * rho / pi, rho = 1, r = 2
    assert abs(float(img.mean()) / expect - 1.0) < 0.03, (img.mean(), expect)
