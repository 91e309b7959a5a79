"""The port's wavefront path tracer on the shading breadth against the JAX
package on the CPU: ``trace`` on 32x32 waves of the furnace, the glass
Cornell box and the Cornell box with an opacity-0 mask on the tall box
(through the tiled intersector and the BVH), from the same keys;
``shadow_transmittance`` through null and mask surfaces; and the fused
kernel's gate, which every new family and emitter kind must fail.
tests/test_torch_shading_scenes.py traces the other scenes, and
tests/test_torch_shading_render.py holds the twins of the JAX package's
furnace and mask-scene render checks (the JAX package's compiles set the
time of each file)."""
import jax.numpy as jnp
import numpy as np
import pytest

from mitsuba_path_guiding_torch.accel.traverse import (
    intersect_brute,
    intersect_bvh,
    intersect_pallas,
    shadow_transmittance,
)
from mitsuba_path_guiding_torch.integrators.path import trace
from mitsuba_path_guiding_torch.models.bsdf import types_present
from mitsuba_path_guiding_torch.models.emitter import kinds_present
from mitsuba_path_guiding_torch.ops.fused_path import fused_supported
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_tpu.accel.traverse import shadow_transmittance as j_shadow_transmittance
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models.sensor import generate_rays as j_generate_rays
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, t

MASK = {"type": "mask", "opacity": [0.0] * 3, "bsdf": {"type": "diffuse"}}
BLEND = {"type": "blendbsdf", "weight": 0.4,
         "bsdfs": [{"type": "diffuse", "reflectance": [0.7, 0.2, 0.2]},
                   {"type": "roughconductor", "material": "Au", "alpha": 0.3}]}


def _tallbox(mod, bsdf):
    sc = mod.cornell_box()
    sc["shapes"][5]["bsdf"] = bsdf
    return sc


def _env_furnace(mod):
    sc = mod.furnace()
    sc["emitters"] = [{"type": "envmap", "image": np.ones((16, 32, 3), np.float32)}]
    return sc


SCENES = {
    "furnace": lambda m: m.furnace(),
    "furnace_env": _env_furnace,
    "glass": lambda m: m.cornell_box(box_material="glass"),
    "mirror": lambda m: m.cornell_box(box_material="mirror"),
    "mask": lambda m: _tallbox(m, MASK),
    "blend": lambda m: _tallbox(m, BLEND),
}
# (scene, use_nee, the port's route): the furnace's 9024 triangles go
# through the BVH here, the Cornell boxes through the tiled intersector.
# The JAX package traces with its BVH where the port does, else with its
# dense oracle: two routes split exact ties apart, which moves a path
# (the JAX package's own BVH and dense traces of the mask scene agree on
# 98.6% of lanes at rtol 1e-4)
CASES = [("furnace", True, "bvh"), ("glass", True, "auto"), ("mask", True, "auto"),
         ("mask", True, "bvh")]


@pytest.fixture(scope="module")
def built():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = (j_build_scene(SCENES[name](jscenes)),
                           build_scene(SCENES[name](tscenes), device="cpu"))
        return cache[name]
    return get


def _wave(jscene, seed=0):
    n = 1024
    pix = jnp.arange(n, dtype=jnp.int32)
    kj = jrng.ray_keys(jrng.base_key(seed), pix, jnp.zeros_like(pix))
    u = jrng.event_uniform(kj, jrng.TAG_CAMERA, 2)
    o, d, _ = j_generate_rays(jscene.sensor, 32, 32, pix, u)
    return o, d, kj


def check_trace(jscene, scene, use_nee, accel):
    o, d, kj = _wave(jscene)
    mat_types, em_kinds = types_present(scene.mats), kinds_present(scene.emitters)
    Lj, auxj, _ = j_trace(jscene, o, d, kj, max_depth=6, rr_depth=3, use_nee=use_nee,
                          use_bvh=accel == "bvh", em_kinds=em_kinds, mat_types=mat_types)
    Lt, auxt, _ = trace(scene, t(o), t(d), t(kj), max_depth=6, rr_depth=3, use_nee=use_nee,
                        em_kinds=em_kinds, mat_types=mat_types, accel=accel)
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0.0
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99
    assert frac_close(auxt.albedo.numpy(), np.asarray(auxj.albedo), rtol=1e-6) >= 0.99


@pytest.mark.parametrize("name,use_nee,accel", CASES)
def test_trace_matches_reference(built, name, use_nee, accel):
    check_trace(*built(name), use_nee, accel)


def test_shadow_transmittance_matches_reference():
    """Null and mask surfaces on the boxes; 4096 rays from points in the
    box toward random directions, a third unbounded, a third short and a
    third dead."""
    def desc(mod):
        sc = _tallbox(mod, {"type": "mask", "opacity": 0.4, "bsdf": {"type": "diffuse"}})
        sc["shapes"][4]["bsdf"] = {"type": "null"}
        return sc
    jscene = j_build_scene(desc(jscenes))
    scene = build_scene(desc(tscenes), device="cpu")
    rs = np.random.default_rng(4)
    n = 4096
    lo, hi = np.asarray(jscene.aabb_min), np.asarray(jscene.aabb_max)
    o = (lo + (hi - lo) * rs.random((n, 3))).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sel = rs.integers(0, 3, n)
    tmax = np.where(sel == 0, 3.0e37, np.where(sel == 1, 2.0 * rs.random(n), -1.0))
    tmax = tmax.astype(np.float32)
    want = np.asarray(j_shadow_transmittance(jscene.geo, jscene.bvh, jscene.mats.packed,
                                             jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax),
                                             use_bvh=False))
    geo = scene.geo
    args = (geo, scene.mats.packed, t(o), t(d), t(tmax))
    dense = shadow_transmittance(*args, lambda o_, d_, t_: intersect_brute(geo, o_, d_, t_)).numpy()
    bvh = shadow_transmittance(
        *args, lambda o_, d_, t_: intersect_bvh(geo, scene.bvh, o_, d_, t_)).numpy()
    route = shadow_transmittance(*args, lambda o_, d_, t_: intersect_pallas(geo, o_, d_, t_)).numpy()
    # every value a product of 1, 0.6 and 0, and 0, 0.6 and 1 all taken
    vals = set(np.round(want.astype(np.float64), 4).tolist())
    assert {0.0, 0.6, 1.0} <= vals <= {0.0, 0.216, 0.36, 0.6, 1.0}
    np.testing.assert_array_equal(dense, want)
    np.testing.assert_array_equal(route, want)
    # a march of four hits crosses box edges, where two routes split exact
    # ties apart: the BVH differs from the dense oracle on 13 of these rays,
    # the JAX package's BVH on 15
    assert frac_close(bvh, want, rtol=1e-6) >= 0.995


@pytest.mark.parametrize("name", sorted(SCENES) + ["veach_mis"])
def test_fused_kernel_refuses_the_new_scenes(built, name):
    scene = build_scene(tscenes.veach_mis(), device="cpu") if name == "veach_mis" \
        else built(name)[1]
    assert not fused_supported(scene)
    assert fused_supported(build_scene(tscenes.cornell_box(), device="cpu"))
