"""The frozen scene copy: the reference's compile agrees with the port's
``build_scene`` (on the copy, and on the repository's door_room at small
sizes, whose tessellated spheres and conductors the reference's compile
also knows), and the copy describes what the repository's own scene
builder describes today."""
import numpy as np
import pytest
import torch

from pgbench.checks.scene import FIELDS, program_side
from pgbench.reference.scene import compile_scene
from pgbench.scenes import cornell


def _door_room(**kw):
    from mitsuba_path_guiding_torch.scene import scenes

    return scenes.door_room(**kw)


def _port(desc):
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    return {k: v.double().numpy() for k, v in program_side(build_scene(desc, device="cpu")).items()}


@pytest.mark.parametrize("make", [cornell.describe, lambda: _door_room(target_tris=2000),
                                  lambda: _door_room(target_tris=600, ajar_deg=25.0)],
                         ids=["cornell", "door_room_2000", "door_room_600_ajar25"])
def test_reference_compile_matches_the_port(make):
    desc = make()
    ref = compile_scene(desc)
    prog = _port(desc)
    assert prog["p0"].shape == ref["p0"].shape
    for f in FIELDS:
        np.testing.assert_allclose(prog[f], ref[f], rtol=0, atol=2e-6 * max(np.abs(ref[f]).max(), 1))


def test_cornell_has_36_triangles():
    assert compile_scene(cornell.describe())["p0"].shape[0] == 36


def test_frozen_copy_equals_the_repository_scene():
    from mitsuba_path_guiding_torch.scene import scenes

    frozen = compile_scene(cornell.describe())
    live = compile_scene(scenes.cornell_box())
    for f in FIELDS + ("refl", "alpha"):
        np.testing.assert_array_equal(frozen[f], live[f])


def test_reference_hits_agree_with_the_port_brute_force():
    from mitsuba_path_guiding_torch.accel.traverse import intersect_brute, occluded_brute
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    from pgbench.reference.hits import queries

    desc = _door_room(target_tris=2000)
    scene = build_scene(desc, device="cpu")
    ref = compile_scene(desc)
    g = torch.Generator().manual_seed(5)
    n = 512
    o = torch.rand((n, 3), generator=g) * torch.tensor([5.0, 2.5, 7.0]) - torch.tensor([2.5, -0.2, 3.8])
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    tmax = torch.where(torch.arange(n) % 3 == 0, torch.full((n,), 2.0), torch.full((n,), 3e37))
    hit = intersect_brute(scene.geo, o, d, tmax)
    occ = occluded_brute(scene.geo, o, d, tmax)
    tris = (ref["p0"], ref["e1"], ref["e2"])
    t_r, h_r = queries(tris, o.double(), d.double(), tmax.double(), torch.zeros(n, dtype=torch.bool))
    _, o_r = queries(tris, o.double(), d.double(), tmax.double(), torch.ones(n, dtype=torch.bool))
    assert torch.equal(h_r, hit.valid) and torch.equal(o_r, occ)
    both = h_r & hit.valid
    assert torch.allclose(t_r[both], hit.t[both].double(), rtol=1e-4)
