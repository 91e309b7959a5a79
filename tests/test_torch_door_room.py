"""door_room(20000) (17510 triangles, above the 16384 threshold, so it
carries pair and blocklist tables) through the port against the JAX
package on the CPU: the compiled scene, a 16x16 depth-5 trace through the
pair route against JAX's ``trace(accel="twolevel")``, and one guided
progression's grid.  On the full door_room(), the camera rays whose proven
pair result is not the nearest triangle are the reference's misses too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.accel.traverse import intersect_brute, intersect_pairs_full
from mitsuba_path_guiding_torch.integrators.path import PAIR_CAP, trace
from mitsuba_path_guiding_torch.integrators.progressive import (
    ProgressiveConfig,
    ProgressiveRenderer,
)
from mitsuba_path_guiding_torch.integrators.render import RenderConfig
from mitsuba_path_guiding_torch.models.bsdf import types_present
from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.ops.intersect_pairs import intersect_pairs_raw
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import door_room
from mitsuba_path_guiding_tpu.accel.bvh import build_bvh as j_build_bvh
from mitsuba_path_guiding_tpu.accel.pairs import build_pair_table as j_build_pair_table
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.integrators import progressive as jprog
from mitsuba_path_guiding_tpu.integrators import render as jrender
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.ops.intersect_pairs import intersect_pairs_raw as j_pairs_raw
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.scenes import door_room as j_door_room
from test_torch_path import _assert_grid_close
from test_torch_scene import _compare
from torch_port_parity import frac_close, port_scene, t

TRIS = 20000


@pytest.fixture(scope="module")
def scenes():
    return j_build_scene(j_door_room(TRIS)), build_scene(door_room(TRIS), device="cpu")


def test_compiled_scene_equals_the_converted_reference(scenes):
    jscene, scene = scenes
    assert scene.geo.p0.shape[0] == 17510 and scene.pairs is not None
    _compare(scene, jscene, "door_room")
    _compare(port_scene(jscene), jscene, "converted")


def test_trace_matches_the_reference_twolevel_route(scenes):
    jscene, scene = scenes
    pix = jnp.arange(256, dtype=jnp.int32)
    kj = jrng.ray_keys(jrng.base_key(0), pix, jnp.zeros_like(pix))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o, d, _ = j_generate_rays(jscene.sensor, 16, 16, pix, u)
    types = types_present(scene.mats)
    assert types == (0, 3)
    Lj, auxj, _ = j_trace(jscene, o, d, kj, max_depth=5, accel="twolevel", em_kinds=(0,),
                          mat_types=types)
    build.reset_launches()
    Lt, auxt, _ = trace(scene, t(o), t(d), t(kj), max_depth=5, em_kinds=(0,), mat_types=types)
    assert sum(build.LAUNCHES.values()) == 0  # the CPU takes the plain versions
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0.0
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99


def test_one_guided_progression_matches_the_reference(scenes):
    jscene, scene = scenes
    kw = dict(samples_per_progression=1, n_progressions=1, guiding=True, grid_res=4, n_lobes=8)
    jr = jprog.ProgressiveRenderer(jscene, jprog.ProgressiveConfig(
        render=jrender.RenderConfig(width=16, height=16, spp=0, max_depth=5,
                                    accel="twolevel"), **kw))
    jr.run_progression()
    pr = ProgressiveRenderer(scene, ProgressiveConfig(
        render=RenderConfig(width=16, height=16, spp=0, max_depth=5), **kw))
    pr.run_progression()
    assert int(pr.grid.valid.sum()) > 0
    # the grid's sums carry the few-ulp differences of the radiance (XLA
    # contracts multiply-adds on the CPU), as tests/test_torch_path.py
    # holds Cornell's grid: counts and weights exact, sums within 1e-3
    for f in ("log_weight", "valid", "s_count"):
        np.testing.assert_array_equal(getattr(pr.grid, f).numpy(), np.asarray(getattr(jr.grid, f)))
    _assert_grid_close(pr.grid, jr.grid, tol=1e-3)


# Camera rays of the full door_room() at 512x512 (seed 0, sample 0) that the
# pair route, proven complete, gives a farther triangle than the dense
# oracle, as float32 bits: origin (2.4, 1.5, -3.4), then the direction and
# the engines that miss.  At pixel 201098 the block of the dividing wall's
# base is a dropped candidate, and the proof, on keys cut to 16 bits, passes
# the floor behind it (tests/test_torch_pair_configs.py::
# test_width_misses_are_the_references); at pixel 197718 the Pluecker test,
# which is not watertight, slips between two sphere triangles.
MISS_ORIGIN = (1075419546, 1069547520, 3227097498)
MISSES = {201098: ((3196194156, 3198133219, 1063936656), ("mt", "plk")),
          197718: ((3208496069, 3197614344, 1058680111), ("plk",))}


@pytest.fixture(scope="module")
def full_door_room():
    scene = build_scene(door_room(), device="cpu")
    p0, e1, e2 = (x.numpy() for x in (scene.geo.p0, scene.geo.e1, scene.geo.e2))
    return scene, j_build_pair_table(p0, e1, e2, j_build_bvh(p0, e1, e2))


@pytest.mark.parametrize("engine", ["mt", "plk"])
def test_pair_route_misses_what_the_reference_misses(full_door_room, engine):
    scene, jpt = full_door_room
    assert scene.geo.p0.shape[0] == 244838
    bits = np.array([MISS_ORIGIN + dbits for dbits, _ in MISSES.values()], np.uint32)
    o, d = bits[:, 0:3].view(np.float32), bits[:, 3:6].view(np.float32)
    tmax = np.full((len(MISSES),), 3.0e37, np.float32)
    got = intersect_pairs_raw(scene.pairs, t(o), t(d), t(tmax), cap_factor=PAIR_CAP,
                              engine=engine)
    want = j_pairs_raw(jpt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), use_pallas=False,
                       cap_factor=PAIR_CAP, engine=engine)
    # proven in both packages, so no fallback re-traces them, with the same
    # triangle
    assert got[5].all() and np.asarray(want[5]).all()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    full = intersect_pairs_full(scene.pairs, scene.blocks, t(o), t(d), t(tmax),
                                cap_factor=PAIR_CAP, engine=engine)
    np.testing.assert_array_equal(full.prim.numpy(), got[1].numpy())
    oracle = intersect_brute(scene.geo, t(o), t(d), t(tmax))
    missed = (full.prim != oracle.prim) & (full.t > oracle.t)
    assert missed.tolist() == [engine in engines for _, engines in MISSES.values()]
    assert torch.equal(full.prim == oracle.prim, ~missed)
