"""Stack-based BVH traversal, closest hit or any hit.

Port of ``mitsuba_path_guiding_tpu/accel/traverse.py`` ``intersect_bvh``,
a vmapped ``lax.while_loop`` over a stack of ``STACK_SIZE`` nodes (not a
Pallas kernel; on the card it is ``csrc/intersect_bvh.cu``, one thread per
ray).  Each step pops a node and slab-tests its box against the ray's
current best t (``ray_aabb``: an axis on which the ray is parallel,
|1/d| >= 1e19, takes a containment test); a leaf tests its up to 4
triangles in order (``moeller_trumbore``, a hit needs EPS_T < t < best
t, so a tie stays with the triangle found first); an inner node pushes
the far child, then the near one (near: entry distance tn0 <= tn1 at the
current best t).  Any-hit stops at the first triangle hit.

On a CUDA tensor ``bvh_query`` launches the kernel and counts the launch
in ``build.LAUNCHES["intersect_bvh"]``; on a CPU tensor it runs
``bvh_plain``, the same walk vectorised over rays, one node per ray per
step.  Both return per-ray work counts: nodes popped and triangles
tested.
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_path_guiding_torch.core.math import cross, dot, safe_rcp
from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.scene.types import BVH

INF = 3.0e38
EPS_T = 1e-4
STACK_SIZE = 48  # traversal stack depth; scene/builder.py checks the tree against it
MAX_LEAF = 4

_FN: dict = {}


def ray_aabb(o, inv_d, bmin, bmax, tmax):
    """Slab test of rays (A, 3) against boxes (A, 3): (hit, t_near)."""
    parallel = torch.abs(inv_d) >= 1e19
    inside = (o >= bmin) & (o <= bmax)
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = torch.where(parallel, torch.where(inside, -INF, INF), torch.minimum(t0, t1))
    hi = torch.where(parallel, torch.where(inside, INF, -INF), torch.maximum(t0, t1))
    tn = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    tf = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return (tf >= torch.clamp_min(tn, 0.0)) & (tn <= tmax), tn


def moeller_trumbore(o, d, p0, e1, e2, tmin, tmax):
    """Moeller-Trumbore of rays against triangles, each (A, 3): (t, u, v,
    hit) with |det| > 1e-12 and tmin < t < tmax."""
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = safe_rcp(det)
    tvec = o - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = ((torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
           & (t < tmax))
    return t, u, v, hit


def bvh_plain(bvh: BVH, p0, e1, e2, o, d, tmax, any_hit: bool = False):
    """Plain version of the kernel.  Returns (t, prim int32, u, v as the
    walk leaves them: t is tmax and prim -1 on a miss; counts (2, N)
    int32: nodes popped, triangles tested)."""
    n = o.shape[0]
    dev = o.device
    inv = safe_rcp(d)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    best_t = tmax.clone()
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    counts = torch.zeros((2, n), dtype=torch.int32, device=dev)
    child0, child1 = bvh.child0.long(), bvh.child1.long()
    prim_idx = bvh.prim_idx.long()
    last = prim_idx.shape[0] - 1
    act = torch.arange(n, device=dev)
    while act.numel():
        oa, da, ia = o[act], d[act], inv[act]
        sp_a = sp[act] - 1
        node = stack[act, sp_a.clamp(0, STACK_SIZE - 1)]
        counts[0, act] += 1
        bt, bp = best_t[act], best_prim[act]
        bu, bv = best_u[act], best_v[act]
        hit_box, _ = ray_aabb(oa, ia, bvh.node_min[node], bvh.node_max[node], bt)
        c0, c1 = child0[node], child1[node]
        leaf = hit_box & (c0 < 0)
        inner = hit_box & (c0 >= 0)
        start, count = -(c0 + 1), -c1
        for k in range(MAX_LEAF):
            tested = leaf & (k < count)
            if any_hit:
                tested = tested & (bp < 0)
            pid = prim_idx[(start + k).clamp(0, last)]
            t, u, v, h = moeller_trumbore(oa, da, p0[pid], e1[pid], e2[pid], EPS_T, bt)
            take = tested & h
            counts[1, act] += tested.to(torch.int32)
            bp = torch.where(take, pid, bp)
            bu = torch.where(take, u, bu)
            bv = torch.where(take, v, bv)
            bt = torch.where(take, t, bt)
        c0c, c1c = c0.clamp_min(0), c1.clamp_min(0)
        _, tn0 = ray_aabb(oa, ia, bvh.node_min[c0c], bvh.node_max[c0c], bt)
        _, tn1 = ray_aabb(oa, ia, bvh.node_min[c1c], bvh.node_max[c1c], bt)
        first = tn0 <= tn1
        near, far = torch.where(first, c0, c1), torch.where(first, c1, c0)
        rows, at = act[inner], sp_a[inner]
        stack[rows, at.clamp(0, STACK_SIZE - 1)] = far[inner]
        stack[rows, (at + 1).clamp(0, STACK_SIZE - 1)] = near[inner]
        sp_new = torch.where(inner, sp_a + 2, sp_a)
        sp[act], best_t[act], best_prim[act] = sp_new, bt, bp
        best_u[act], best_v[act] = bu, bv
        alive = sp_new > 0
        if any_hit:
            alive = alive & (bp < 0)
        act = act[alive]
    return best_t, best_prim.to(torch.int32), best_u, best_v, counts


def _kernel_fn(any_hit: bool):
    key = "any" if any_hit else "closest"
    f = _FN.get(key)
    if f is None:
        f = getattr(build.load("intersect_bvh"), f"bvh_{key}")
        # (o, d, tmax, n, node_min, node_max, child0, child1, prim_idx,
        #  n_prim_idx, p0, e1, e2, out_t, out_prim, out_u, out_v, counts,
        #  stream)
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5
                      + [ctypes.c_int] + [ctypes.c_void_p] * 9)
        f.restype = ctypes.c_int
        _FN[key] = f
    return f


def bvh_cuda(bvh: BVH, p0, e1, e2, o, d, tmax, any_hit: bool = False):
    """Launch the CUDA kernel; the contract of ``bvh_plain``."""
    tables = (bvh.node_min, bvh.node_max, bvh.child0, bvh.child1, bvh.prim_idx, p0, e1, e2)
    if not all(x.is_cuda for x in (*tables, o, d, tmax)):
        raise ValueError("intersect_bvh: all tensors must be on the card")
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or tmax.shape != (n,):
        raise ValueError("intersect_bvh: o, d must be (N, 3) and tmax (N,)")
    if any(x.dtype != torch.float32 for x in (bvh.node_min, bvh.node_max, p0, e1, e2, o, d, tmax)):
        raise TypeError("intersect_bvh: expected float32 rays, boxes and triangles")
    if any(x.dtype != torch.int32 for x in (bvh.child0, bvh.child1, bvh.prim_idx)):
        raise TypeError("intersect_bvh: expected int32 children and prim_idx")
    if bvh.max_depth + 2 > STACK_SIZE:
        raise ValueError(f"intersect_bvh: BVH depth {bvh.max_depth} exceeds the stack")
    # the kernel reads these while it runs: keep every buffer referenced
    tables = tuple(x.contiguous() for x in tables)
    o, d, tmax = o.contiguous(), d.contiguous(), tmax.contiguous()
    dev = o.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    counts = torch.empty((2, n), dtype=torch.int32, device=dev)
    args = (build.ptr(o), build.ptr(d), build.ptr(tmax), n,
            *(build.ptr(x) for x in tables[:5]), tables[4].shape[0],
            *(build.ptr(x) for x in tables[5:]),
            build.ptr(t), build.ptr(prim), build.ptr(u), build.ptr(v), build.ptr(counts),
            build.stream_ptr(dev))
    build.check(_kernel_fn(any_hit)(*args), "intersect_bvh")
    build.LAUNCHES["intersect_bvh"] += 1
    return t, prim, u, v, counts


def bvh_query(bvh: BVH, p0, e1, e2, o, d, tmax, any_hit: bool = False):
    """The kernel (CUDA) or its plain version (CPU): (t, prim, u, v,
    counts)."""
    fn = bvh_cuda if o.is_cuda else bvh_plain
    return fn(bvh, p0, e1, e2, o, d, tmax, any_hit)
