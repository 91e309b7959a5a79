"""Helpers shared by the tests/test_torch_*.py parity tests: hand the JAX
package's containers to the PyTorch port as numpy."""
import numpy as np
import torch


def to_numpy_tree(x):
    """NamedTuple trees of jax arrays -> nested dicts of numpy arrays
    (None and Python scalars kept)."""
    if x is None or isinstance(x, (bool, int, float)):
        return x
    if hasattr(x, "_fields"):
        return {f: to_numpy_tree(getattr(x, f)) for f in x._fields}
    return np.asarray(x)


def port_scene(jax_scene):
    from mitsuba_path_guiding_torch.convert import scene_from_numpy

    return scene_from_numpy(to_numpy_tree(jax_scene), device="cpu")


def port_grid(jax_grid):
    from mitsuba_path_guiding_torch.convert import grid_from_numpy

    return grid_from_numpy(to_numpy_tree(jax_grid), device="cpu")


def t(x, dtype=None):
    """numpy/jax array -> CPU tensor (uint32 keys become int64)."""
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def frac_close(a, b, rtol, atol=1e-6):
    """Fraction of lanes whose every component agrees."""
    a, b = np.asarray(a), np.asarray(b)
    ok = np.isclose(a, b, rtol=rtol, atol=atol)
    if ok.ndim > 1:
        ok = ok.all(axis=-1)
    return float(ok.mean())


def reference_walk_pops(bvh, p0, e1, e2, o, d, tmax):
    """Nodes popped by the reference's closest-hit BVH walk
    (mitsuba_path_guiding_tpu/accel/traverse.py intersect_bvh), which
    pushes both children of every inner node whose box passed and tests
    each box when it pops it; vectorised over rays in torch, on any
    device.  The port's walk tests each box once, at its parent, and on a
    closest-hit walk its box-test count must equal this."""
    from mitsuba_path_guiding_torch.core.math import safe_rcp
    from mitsuba_path_guiding_torch.ops.intersect_bvh import (
        EPS_T,
        MAX_LEAF,
        STACK_SIZE,
        moeller_trumbore,
        ray_aabb,
    )

    n, dev = o.shape[0], o.device
    inv = safe_rcp(d)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = tmax.clone()
    pops = torch.zeros((n,), dtype=torch.int32, device=dev)
    child0, child1, prim_idx = bvh.child0.long(), bvh.child1.long(), bvh.prim_idx.long()
    top, last = STACK_SIZE - 1, prim_idx.shape[0] - 1
    act = torch.arange(n, device=dev)
    while act.numel():
        oa, da, ia = o[act], d[act], inv[act]
        sp_a = sp[act] - 1
        node = stack[act, sp_a.clamp(0, top)]
        pops[act] += 1
        bt = best_t[act]
        hit_box, _ = ray_aabb(oa, ia, bvh.node_min[node], bvh.node_max[node], bt)
        c0, c1 = child0[node], child1[node]
        leaf, inner = hit_box & (c0 < 0), hit_box & (c0 >= 0)
        for k in range(MAX_LEAF):
            pid = prim_idx[(-(c0 + 1) + k).clamp(0, last)]
            t, _, _, h = moeller_trumbore(oa, da, p0[pid], e1[pid], e2[pid], EPS_T, bt)
            bt = torch.where(leaf & (k < -c1) & h, t, bt)
        c0c, c1c = c0.clamp_min(0), c1.clamp_min(0)
        _, tn0 = ray_aabb(oa, ia, bvh.node_min[c0c], bvh.node_max[c0c], bt)
        _, tn1 = ray_aabb(oa, ia, bvh.node_min[c1c], bvh.node_max[c1c], bt)
        first = tn0 <= tn1
        rows, at = act[inner], sp_a[inner]
        stack[rows, at.clamp(0, top)] = torch.where(first, c1, c0)[inner]
        stack[rows, (at + 1).clamp(0, top)] = torch.where(first, c0, c1)[inner]
        sp_new = torch.where(inner, sp_a + 2, sp_a)
        sp[act], best_t[act] = sp_new, bt
        act = act[sp_new > 0]
    return pops
