"""The rest of the shading breadth's traces against the JAX package on the
CPU: ``trace`` on 32x32 waves of the furnace with NEE off and lit by an
environment map, of the mirror Cornell box and of the Cornell box with a
blend on the tall box (tests/test_torch_shading_path.py holds the rest)."""
import numpy as np
import pytest

from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from test_torch_shading_path import SCENES, check_trace


@pytest.mark.parametrize("name,use_nee,accel", [
    ("furnace", False, "bvh"), ("furnace_env", True, "bvh"), ("mirror", True, "auto"),
    ("blend", True, "auto")])
def test_trace_matches_reference(name, use_nee, accel):
    check_trace(j_build_scene(SCENES[name](jscenes)),
                build_scene(SCENES[name](tscenes), device="cpu"), use_nee, accel)


def test_cli_renders_furnace_on_the_cpu(tmp_path):
    from mitsuba_path_guiding_torch.render import main

    out = tmp_path / "furnace.npy"
    assert main(["furnace", "-o", str(out), "-s", "4", "-p", "2", "-d", "3", "-r", "16x16",
                 "--seed", "1", "--device", "cpu"]) == 0
    img = np.load(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    # the top rows see the unit environment, the sphere's centre half of it
    np.testing.assert_allclose(img[0:2].mean(), 1.0, atol=1e-3)
    assert abs(img[6:10, 6:10].mean() - 0.5) < 0.05
    assert 0.5 < img.mean() < 1.0


def test_cli_renders_veach_on_the_cpu(tmp_path):
    from mitsuba_path_guiding_torch.render import main

    out = tmp_path / "veach.npy"
    assert main(["veach", "-o", str(out), "-s", "2", "-p", "2", "-d", "3", "-r", "16x16",
                 "-G", "--device", "cpu"]) == 0
    img = np.load(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0.0
    # the volumetric box renders too (tests/test_torch_volpath.py checks it)
    vol = tmp_path / "v.npy"
    assert main(["volbox", "-o", str(vol), "-s", "1", "-p", "1", "-d", "2", "-r", "8x8",
                 "--device", "cpu"]) == 0
    assert np.isfinite(np.load(vol)).all()
