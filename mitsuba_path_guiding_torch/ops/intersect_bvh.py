"""Stack-based BVH traversal, closest hit or any hit.

Port of ``mitsuba_path_guiding_tpu/accel/traverse.py`` ``intersect_bvh``,
a vmapped ``lax.while_loop`` over a stack of ``STACK_SIZE`` nodes (not a
Pallas kernel; on the card it is ``csrc/intersect_bvh.cu``, one thread per
ray).  The walk tests each box once, at its parent (``ray_aabb``: an axis
on which the ray is parallel, |1/d| >= 1e19, takes a containment test):
the root's box first, against tmax; then each step pops a (node, t_near)
entry and drops it if t_near exceeds the best t so far; a leaf tests its
up to 4 triangles in order (``moeller_trumbore``, a hit needs EPS_T < t <
best t, so a tie stays with the triangle found first); an inner node
slab-tests both children against the best t and pushes the far child if
its box passed, then the near one if its box passed (near: entry distance
tn0 <= tn1).  Any-hit stops at the first hit.  This visits the reference's
leaves in the reference's order, which pushes both children and tests
each box again when it pops it, so t, prim, u and v are the reference's
(the proof is in ``csrc/device_math.cuh`` ``pg_bvh_walk``).

Both paths read the triangles from the BVH's packed layout
(``accel/bvh.py`` ``pack_bvh``, built with the tree in the scene), so
they cannot see different geometry.  On a CUDA tensor ``bvh_query``
launches the kernel, which reads the packed nodes as well, and counts the
launch in ``build.LAUNCHES["intersect_bvh"]``; on a CPU tensor it runs
``bvh_plain``, the same walk vectorised over rays, one node per ray per
step, over the unpacked nodes.  Both return per-ray work counts: boxes
tested (on a closest-hit walk, the reference's nodes popped) and
triangles tested.
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_path_guiding_torch.accel.bvh import MAX_LEAF, NODE_WORDS, TRI_WORDS
from mitsuba_path_guiding_torch.core.math import cross, dot, safe_rcp
from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.scene.types import BVH

INF = 3.0e38
EPS_T = 1e-4
STACK_SIZE = 48  # traversal stack depth; scene/builder.py checks the tree against it

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


def _packed_tris(bvh: BVH):
    if bvh.packed_nodes is None or bvh.packed_tris is None:
        raise ValueError("intersect_bvh: the BVH has no packed layout (accel/bvh.py pack_bvh)")
    return bvh.packed_tris


def bvh_plain(bvh: BVH, o, d, tmax, any_hit: bool = False):
    """Plain version of the kernel.  Returns (t, prim int32, u, v as the
    walk leaves them: t is tmax and prim -1 on a miss; counts (2, N)
    int32: boxes tested, triangles tested)."""
    tris = _packed_tris(bvh)
    tri_id = tris.view(torch.int32)[:, 9].long()
    n = o.shape[0]
    dev = o.device
    inv = safe_rcp(d)
    stack = torch.zeros((n, STACK_SIZE), dtype=torch.int64, device=dev)
    stack_tn = torch.zeros((n, STACK_SIZE), dtype=torch.float32, device=dev)
    best_t = tmax.clone()
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    counts = torch.zeros((2, n), dtype=torch.int32, device=dev)
    counts[0] = 1
    child0, child1 = bvh.child0.long(), bvh.child1.long()
    last = tris.shape[0] - 1
    root_hit, stack_tn[:, 0] = ray_aabb(o, inv, bvh.node_min[0].expand(n, 3),
                                        bvh.node_max[0].expand(n, 3), tmax)
    sp = root_hit.long()
    act = torch.nonzero(root_hit).flatten()
    top = STACK_SIZE - 1
    while act.numel():
        oa, da, ia = o[act], d[act], inv[act]
        sp_a = sp[act] - 1
        node = stack[act, sp_a.clamp(0, top)]
        bt, bp = best_t[act], best_prim[act]
        bu, bv = best_u[act], best_v[act]
        live = ~(stack_tn[act, sp_a.clamp(0, top)] > bt)
        c0, c1 = child0[node], child1[node]
        leaf = live & (c0 < 0)
        inner = live & (c0 >= 0)
        start, count = -(c0 + 1), -c1
        for k in range(MAX_LEAF):
            tested = leaf & (k < count)
            if any_hit:
                tested = tested & (bp < 0)
            j = (start + k).clamp(0, last)
            row, pid = tris[j], tri_id[j]
            t, u, v, h = moeller_trumbore(oa, da, row[:, 0:3], row[:, 3:6], row[:, 6:9], EPS_T, bt)
            take = tested & h
            counts[1, act] += tested.to(torch.int32)
            bp = torch.where(take, pid, bp)
            bu = torch.where(take, u, bu)
            bv = torch.where(take, v, bv)
            bt = torch.where(take, t, bt)
        c0c, c1c = c0.clamp_min(0), c1.clamp_min(0)
        h0, tn0 = ray_aabb(oa, ia, bvh.node_min[c0c], bvh.node_max[c0c], bt)
        h1, tn1 = ray_aabb(oa, ia, bvh.node_min[c1c], bvh.node_max[c1c], bt)
        counts[0, act] += 2 * inner.to(torch.int32)
        first = tn0 <= tn1
        at = sp_a
        for child, tn, hit in ((torch.where(first, c1, c0), torch.where(first, tn1, tn0),
                                torch.where(first, h1, h0)),
                               (torch.where(first, c0, c1), torch.where(first, tn0, tn1),
                                torch.where(first, h0, h1))):
            push = inner & hit
            rows, pos = act[push], at[push].clamp(0, top)
            stack[rows, pos], stack_tn[rows, pos] = child[push], tn[push]
            at = at + push.long()
        sp[act], best_t[act], best_prim[act] = at, bt, bp
        best_u[act], best_v[act] = bu, bv
        alive = at > 0
        if any_hit:
            alive = alive & (bp < 0)
        act = act[alive]
    return best_t, best_prim.to(torch.int32), best_u, best_v, counts


def _kernel_fn(any_hit: bool):
    key = "any" if any_hit else "closest"
    f = _FN.get(key)
    if f is None:
        lib = build.load("intersect_bvh")
        lib.bvh_record_words.argtypes, lib.bvh_record_words.restype = [ctypes.c_int], ctypes.c_int
        if (lib.bvh_record_words(0), lib.bvh_record_words(1)) != (NODE_WORDS, TRI_WORDS):
            raise RuntimeError("intersect_bvh: the kernel reads another packed layout")
        f = getattr(lib, f"bvh_{key}")
        # (o, d, tmax, n, packed_nodes, packed_tris, n_tris, out_t,
        #  out_prim, out_u, out_v, counts, stream)
        f.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                      + [ctypes.c_int] + [ctypes.c_void_p] * 6)
        f.restype = ctypes.c_int
        _FN[key] = f
    return f


def bvh_cuda(bvh: BVH, o, d, tmax, any_hit: bool = False):
    """Launch the CUDA kernel; the contract of ``bvh_plain``."""
    tables = (bvh.packed_nodes, _packed_tris(bvh))
    if not all(x.is_cuda for x in (*tables, o, d, tmax)):
        raise ValueError("intersect_bvh: all tensors must be on the card")
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or tmax.shape != (n,):
        raise ValueError("intersect_bvh: o, d must be (N, 3) and tmax (N,)")
    if any(x.dtype != torch.float32 for x in (*tables, o, d, tmax)):
        raise TypeError("intersect_bvh: expected float32 rays and packed tables")
    if bvh.max_depth + 2 > STACK_SIZE:
        raise ValueError(f"intersect_bvh: BVH depth {bvh.max_depth} exceeds the stack")
    # the kernel reads these while it runs: keep every buffer referenced
    nodes, tris = (x.contiguous() for x in tables)
    o, d, tmax = o.contiguous(), d.contiguous(), tmax.contiguous()
    dev = o.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    counts = torch.empty((2, n), dtype=torch.int32, device=dev)
    args = (build.ptr(o), build.ptr(d), build.ptr(tmax), n, build.ptr(nodes), build.ptr(tris),
            tris.shape[0], build.ptr(t), build.ptr(prim), build.ptr(u), build.ptr(v),
            build.ptr(counts), build.stream_ptr(dev))
    build.check(_kernel_fn(any_hit)(*args), "intersect_bvh")
    build.LAUNCHES["intersect_bvh"] += 1
    return t, prim, u, v, counts


def bvh_query(bvh: BVH, o, d, tmax, any_hit: bool = False):
    """The kernel (CUDA) or its plain version (CPU): (t, prim, u, v,
    counts)."""
    fn = bvh_cuda if o.is_cuda else bvh_plain
    return fn(bvh, o, d, tmax, any_hit)
