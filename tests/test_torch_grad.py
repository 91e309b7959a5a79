"""Gradients through the port against the JAX package on the CPU.

``ops/gather.py`` ``GatherRowsT``: its backward on a (40, 32) table and
4096 indices with repeats and indices outside the table is within 1e-6 of
the reference's vjp rule (gather_pallas.py ``_bwd``) and of ``jax.vjp``
of its plain gather, and bit-equal to autograd's gradient of the plain
version.  Every ctypes wrapper without a backward raises a RuntimeError
that names its kernel when grad mode is on and an input requires grad
(before it looks at the device; under ``torch.no_grad`` the same call
fails only for its CPU tensors), and the fused kernel's gate sends a scene
whose tables require grad to the wavefront path.  The tiled kernel's
closest hit re-evaluated at its winner (``winner_with_grad``) is
bit-equal to the plain version's, with the same gradient with respect to
the rays.  tests/test_grad.py's three gradients through the port's
``trace`` (the furnace at 512 rays x 2 samples by the BVH, the Cornell
box at the test's 1024 x 2, the emitter scale at 1024) are within 1e-3
relative of ``jax.grad`` on the same rays and pass the test's own bars
(the furnace's central difference within 5%, three reflectances with
influence, dL/dscale within 1e-4 of L(1)); ``render``'s gradient of the
Cornell box at 8x8 x 2 spp within 1e-3 of ``jax.grad`` through the
reference's ``render``.
"""
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, _fused_gate, render
from mitsuba_path_guiding_torch.ops.gather import (
    GatherRowsT,
    gather_rows_t,
    gather_rows_t_cuda,
    gather_rows_t_plain,
)
from mitsuba_path_guiding_torch.ops.intersect_tiled import (
    pack_triangles,
    tiled_plain,
    winner_with_grad,
)
from mitsuba_path_guiding_tpu.ops import gather_pallas
from torch_port_parity import t

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import slice13_reference_means as ref  # noqa: E402

GRAD_RTOL = 1e-3
SMALL = {"furnace": (512, 2, "bvh"), "cornell": (None, None, "auto"),
         "emitter": (None, None, "auto")}


@pytest.fixture(scope="module")
def scenes():
    return ref.jax_grad_scenes(), chip_smoke.grad_scenes("cpu")


def _gather_inputs():
    gen = np.random.default_rng(0)
    table = gen.standard_normal((40, 32)).astype(np.float32)
    idx = gen.integers(-3, 45, 4096).astype(np.int32)
    g = gen.standard_normal((32, 4096)).astype(np.float32)
    return table, idx, g


def test_gather_backward_matches_jax_vjp():
    table, idx, g = _gather_inputs()
    tab = t(table).requires_grad_()
    out = gather_rows_t(tab, t(idx))
    assert type(out.grad_fn).__name__.startswith(GatherRowsT.__name__)
    out.backward(t(g))
    got = tab.grad.numpy()
    want_rule, none = gather_pallas._bwd((jnp.asarray(idx), table.shape), jnp.asarray(g))
    assert none is None
    _, vjp = jax.vjp(lambda tb: gather_pallas.gather_rows_t(tb, jnp.asarray(idx)),
                     jnp.asarray(table))
    np.testing.assert_allclose(got, np.asarray(want_rule), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(vjp(jnp.asarray(g))[0]), rtol=0, atol=1e-6)
    plain = t(table).requires_grad_()
    gather_rows_t_plain(plain, t(idx)).backward(t(g))
    assert torch.equal(tab.grad, plain.grad)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(gather_pallas.gather_rows_t(jnp.asarray(table),
                                                                         jnp.asarray(idx))))


def test_gather_without_grad_takes_the_direct_call():
    table, idx, _ = _gather_inputs()
    assert gather_rows_t(t(table), t(idx)).grad_fn is None
    with torch.no_grad():
        assert gather_rows_t(t(table).requires_grad_(), t(idx)).grad_fn is None


def _wrapper_calls():
    """Each ctypes wrapper without a backward, called on CPU tensors with
    one float input that requires grad: (kernel name, call)."""
    from mitsuba_path_guiding_torch.ops import intersect_blocklist, intersect_bvh, intersect_pairs
    from mitsuba_path_guiding_torch.ops import intersect_twolevel
    from mitsuba_path_guiding_torch.ops.fused_path import FusedTables, trace_fused_cuda

    z = torch.zeros((8, 3))
    o = torch.zeros((8, 3), requires_grad=True)
    tmax = torch.ones((8,))
    i32 = torch.zeros((1,), dtype=torch.int32)
    bvh = types.SimpleNamespace(packed_nodes=torch.zeros((4, 16)), packed_tris=torch.zeros((4, 16)))
    bl = types.SimpleNamespace(tri_pack=torch.zeros((1, 16, 32)), blk_box=torch.zeros((1, 16, 8)))
    bt = intersect_twolevel.BlockTable(*(torch.zeros((1, 3)) for _ in range(5)))
    tables = FusedTables(torch.zeros((8, 25)), torch.zeros((8, 32)), torch.zeros((8, 32)),
                         torch.zeros((8, 8), requires_grad=True), 1, 1, 1)
    keys = torch.zeros((8, 2), dtype=torch.int64)
    return {
        "gather_rows_t": lambda: gather_rows_t_cuda(torch.zeros((4, 8), requires_grad=True),
                                                    i32),
        "trace_fused": lambda: trace_fused_cuda(tables, z, z, keys),
        "intersect_bvh": lambda: intersect_bvh.bvh_cuda(bvh, o, z, tmax),
        "intersect_blocklist": lambda: intersect_blocklist.blocklist_cuda(bl, o, z, tmax, i32,
                                                                          i32),
        "intersect_pairs mt": lambda: intersect_pairs._launch(
            "mt", torch.zeros((1, 10, 32)), torch.zeros((1, 10, 32)), i32,
            torch.zeros((7, 128), requires_grad=True), False),
        "intersect_twolevel": lambda: intersect_twolevel.twolevel_cuda(
            bt, torch.zeros((6, 8), requires_grad=True), tmax, i32, i32),
    }


@pytest.mark.parametrize("kernel", ["gather_rows_t", "trace_fused", "intersect_bvh",
                                    "intersect_blocklist", "intersect_pairs mt",
                                    "intersect_twolevel"])
def test_cuda_wrappers_refuse_grad(kernel):
    call = _wrapper_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"^{kernel}: the CUDA kernel has no backward"):
        call()
    # without grad mode the wrapper goes on to its checks (CPU tensors fail them)
    with torch.no_grad(), pytest.raises((ValueError, TypeError)):
        call()


def test_winner_with_grad_matches_plain(scenes):
    sc = scenes[1]["cornell"]
    pack = pack_triangles(sc.geo.p0, sc.geo.e1, sc.geo.e2)
    n_tri = sc.geo.p0.shape[0]
    gen = torch.Generator().manual_seed(3)
    o0, d0, _ = chip_smoke.random_rays(sc, 2048, gen, mixed_tmax=False)
    tmax = torch.full((2048,), 3.0e37)
    outs, grads = [], []
    for route in ("plain", "winner"):
        o, d = o0.clone().requires_grad_(), d0.clone().requires_grad_()
        hit = tiled_plain(pack, o, d, tmax, n_tri)
        if route == "winner":
            hit = winner_with_grad(pack, o, d, *(x.detach() for x in hit[:4]))
        (hit[0].clamp_max(1e3).sum() + hit[2].sum() + hit[3].sum()).backward()
        outs.append(hit)
        grads.append((o.grad, d.grad))
    assert 0.5 < float(outs[0][4].float().mean()) < 1.0
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_fused_gate_refuses_grad(scenes):
    sc = scenes[1]["cornell"]
    cuda = torch.device("cuda")
    cfg = RenderConfig()
    assert _fused_gate(sc, cfg, None, cuda) is not None
    graded = sc._replace(mats=sc.mats._replace(packed=sc.mats.packed.clone().requires_grad_()))
    assert _fused_gate(graded, cfg, None, cuda) is None
    with torch.no_grad():
        assert _fused_gate(graded, cfg, None, cuda) is not None


@pytest.mark.parametrize("run", list(chip_smoke.GRAD_RUNS))
def test_gradients_match_jax(scenes, run):
    n_rays, seeds, accel = SMALL[run]
    want = ref.jax_gradient(run, scenes[0], n_rays, seeds)
    got = chip_smoke.port_gradient(run, scenes[1], n_rays, seeds, accel=accel)
    g, w = np.asarray(got["grad"]), np.asarray(want["grad"])
    assert np.isfinite(g).all()
    assert np.abs(g - w).max() <= GRAD_RTOL * np.abs(w).max(), (g, w)
    if run == "furnace":  # test_grad.py's bar: the central difference within 5%
        assert g != 0.0
        assert abs(g - got["fd"]) / abs(got["fd"]) < chip_smoke.GRAD_FD_TOL
        assert abs(got["fd"] - want["fd"]) <= GRAD_RTOL * abs(want["fd"])
    elif run == "cornell":  # every diffuse material's reflectance has influence
        assert (np.abs(g).sum(axis=1) > 0).sum() >= 3
    else:  # linear in emission: dL/dscale at 1 == L(1)
        assert abs(g - got["base"]) / got["base"] < 1e-4
        assert abs(got["base"] - want["base"]) <= GRAD_RTOL * want["base"]


def test_render_gradient_matches_jax(scenes):
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
    from mitsuba_path_guiding_tpu.integrators.render import render as jrender

    cfg = dict(width=8, height=8, spp=2, max_depth=3)
    jsc, sc = scenes[0]["cornell"], scenes[1]["cornell"]
    want = np.asarray(jax.grad(lambda p: jrender(
        jsc._replace(mats=jsc.mats._replace(packed=p)), JRenderConfig(**cfg)).mean())(
        jsc.mats.packed))
    packed = sc.mats.packed.clone().requires_grad_()
    render(sc._replace(mats=sc.mats._replace(packed=packed)), RenderConfig(**cfg)).mean().backward()
    got = packed.grad.numpy()
    assert (np.abs(got[:, 1:4]).sum(axis=1) > 0).sum() >= 3
    assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max()
