"""Twins of the JAX package's render checks of the shading breadth on the
CPU (tests/test_render.py, tests/test_materials_e2e.py): the white
furnace with NEE and the zero-variance furnace without, whose bars are
analytic, and the opacity-0 mask that hides the tall box of the Cornell
box."""
import numpy as np
import pytest

from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from test_torch_shading_path import MASK, _tallbox


@pytest.fixture(scope="module")
def furnace_scene():
    return build_scene(tscenes.furnace(albedo=0.5, env_radiance=1.0), device="cpu")


def test_furnace_nee(furnace_scene):
    img = render(furnace_scene, RenderConfig(width=24, height=24, spp=48, max_depth=5,
                                             accel="bvh")).numpy()
    assert np.isfinite(img).all()
    # the background sees the environment directly
    np.testing.assert_allclose(img[0:3].mean(), 1.0, atol=1e-3)
    # a convex diffuse sphere in a constant environment: albedo * env
    assert abs(img[10:14, 10:14].mean() - 0.5) < 0.02


def test_furnace_bsdf_only_exact(furnace_scene):
    # cosine sampling in a constant environment is zero-variance
    img = render(furnace_scene, RenderConfig(width=24, height=24, spp=8, max_depth=5,
                                             use_nee=False, accel="bvh")).numpy()
    np.testing.assert_allclose(img[10:14, 10:14].mean(), 0.5, atol=1e-4)


def test_mask_scene():
    """An opacity-0 mask makes the tall box invisible: the image is close
    to the Cornell box without it."""
    sc_mask = build_scene(_tallbox(tscenes, MASK), device="cpu")
    base = tscenes.cornell_box()
    del base["shapes"][5]
    sc_removed = build_scene(base, device="cpu")
    # pass-throughs spend path depth, as every vertex does
    cfg = RenderConfig(width=24, height=24, spp=24, max_depth=9, seed=1)
    img_m = render(sc_mask, cfg).numpy()
    img_r = render(sc_removed, cfg).numpy()
    np.testing.assert_allclose(img_m.mean(), img_r.mean(), rtol=0.05)
