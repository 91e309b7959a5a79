"""Host-side binned-SAH BVH builder (port of the reference's accel/bvh.py).

Binned SAH with 16 bins over the widest centroid axis, leaves of at most
4 triangles, built by the native builder (``accel/native.py``, g++) where
it can be built and otherwise by the same algorithm in numpy, which gives
the same tree.  The tree comes back as numpy arrays: the scene compiler
cuts its block and pair tables from them before anything moves to the
device (``scene/builder.py``), so no device readback is ever needed.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from mitsuba_path_guiding_torch.accel.native import build_bvh_native, native_available
from mitsuba_path_guiding_torch.scene.types import BVH

N_BINS = 16
MAX_LEAF = 4     # triangles a leaf holds at most (the walk tests no more)
TRAVERSAL_COST = 1.0
INTERSECT_COST = 1.0
NODE_WORDS = 16  # one packed inner node: both children's boxes and references
TRI_WORDS = 12   # one packed triangle: p0, e1, e2 and its original id


def _box_pad(v0, v1, v2) -> float:
    extent = float((np.maximum(np.maximum(v0, v1), v2).max(axis=0)
                    - np.minimum(np.minimum(v0, v1), v2).min(axis=0)).max())
    return 1e-6 * max(extent, 1.0)


def build_bvh(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray, use_native: bool = True) -> BVH:
    """BVH of numpy arrays from triangle (p0, e1, e2) float32 arrays: the
    native builder's where ``use_native`` and it can be built, else the
    numpy builder's."""
    if use_native and native_available():
        node_min, node_max, child0, child1, prim_idx, max_depth = build_bvh_native(
            p0, e1, e2, _box_pad(p0, p0 + e1, p0 + e2))
        return BVH(node_min=node_min, node_max=node_max, child0=child0, child1=child1,
                   prim_idx=prim_idx, max_depth=max_depth + 2)
    return _build_bvh_numpy(p0, e1, e2)


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 0] * d[..., 2])


def _median_split(idx, centroids, axis):
    order = np.argsort(centroids[idx, axis], kind="stable")
    half = len(idx) // 2
    return idx[order[:half]], idx[order[half:]]


def _build_bvh_numpy(p0, e1, e2) -> BVH:
    """The reference's numpy builder: nodes in depth-first order (a node,
    its left subtree, its right subtree), boxes padded by 1e-6 of the
    scene's extent (at least 1e-6), since the triangle test tolerates an
    ulp of slop and a box must too."""
    T = p0.shape[0]
    v0, v1, v2 = p0, p0 + e1, p0 + e2
    tri_min = np.minimum(np.minimum(v0, v1), v2)
    tri_max = np.maximum(np.maximum(v0, v1), v2)
    centroids = (tri_min + tri_max) * 0.5
    extent = float((tri_max.max(axis=0) - tri_min.min(axis=0)).max())
    box_pad = 1e-6 * max(extent, 1.0)
    tri_min = tri_min - box_pad
    tri_max = tri_max + box_pad

    node_min, node_max, child0, child1 = [], [], [], []
    prim_order: list[int] = []
    max_depth_seen = [0]

    def build(idx: np.ndarray, depth: int) -> int:
        node = len(child0)
        bmin = tri_min[idx].min(axis=0)
        bmax = tri_max[idx].max(axis=0)
        node_min.append(bmin)
        node_max.append(bmax)
        child0.append(0)
        child1.append(0)
        max_depth_seen[0] = max(max_depth_seen[0], depth)
        n = len(idx)
        if n <= MAX_LEAF:
            child0[node] = -(len(prim_order) + 1)
            child1[node] = -n
            prim_order.extend(idx.tolist())
            return node
        cmin = centroids[idx].min(axis=0)
        ext = centroids[idx].max(axis=0) - cmin
        axis = int(np.argmax(ext))
        if ext[axis] < 1e-12:  # degenerate spread
            l_idx, r_idx = _median_split(idx, centroids, axis)
        else:
            scale = N_BINS * (1.0 - 1e-6) / ext[axis]
            bins = np.clip(((centroids[idx, axis] - cmin[axis]) * scale).astype(np.int32),
                           0, N_BINS - 1)
            counts = np.zeros(N_BINS, dtype=np.int64)
            bmin_b = np.full((N_BINS, 3), np.inf)
            bmax_b = np.full((N_BINS, 3), -np.inf)
            for b in range(N_BINS):
                m = bins == b
                counts[b] = m.sum()
                if counts[b]:
                    bmin_b[b] = tri_min[idx[m]].min(axis=0)
                    bmax_b[b] = tri_max[idx[m]].max(axis=0)
            lmin = np.minimum.accumulate(bmin_b, axis=0)
            lmax = np.maximum.accumulate(bmax_b, axis=0)
            rmin = np.minimum.accumulate(bmin_b[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bmax_b[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = np.cumsum(counts[::-1])[::-1]
            # split after bin s: bins [0..s] left, [s+1..] right
            cost = np.full(N_BINS - 1, np.inf)
            for s in range(N_BINS - 1):
                if lcount[s] and rcount[s + 1]:
                    cost[s] = (_area(lmin[s], lmax[s]) * lcount[s]
                               + _area(rmin[s + 1], rmax[s + 1]) * rcount[s + 1])
            s = int(np.argmin(cost))
            if np.isfinite(cost[s]):
                m = bins <= s
                l_idx, r_idx = idx[m], idx[~m]
            else:
                l_idx, r_idx = _median_split(idx, centroids, axis)
        child0[node] = build(l_idx, depth + 1)
        child1[node] = build(r_idx, depth + 1)
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100 + 4 * T))
    try:
        build(np.arange(T, dtype=np.int64), 0)
    finally:
        sys.setrecursionlimit(old_limit)
    return BVH(node_min=np.stack(node_min).astype(np.float32),
               node_max=np.stack(node_max).astype(np.float32),
               child0=np.asarray(child0, dtype=np.int32), child1=np.asarray(child1, dtype=np.int32),
               prim_idx=np.asarray(prim_order, dtype=np.int32), max_depth=max_depth_seen[0] + 2)


def bvh_host_arrays(bvh):
    """(child0, child1, prim_idx) as host numpy arrays."""
    return tuple(np.asarray(x.cpu()) if torch.is_tensor(x) else np.asarray(x)
                 for x in (bvh.child0, bvh.child1, bvh.prim_idx))


def to_device(tables, dev):
    """A NamedTuple of numpy arrays (and host ints) on ``dev``."""
    return type(tables)(*(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                          if isinstance(x, np.ndarray) else x for x in tables))


def pack_bvh(bvh: BVH, p0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor) -> BVH:
    """``bvh`` with the packed layout of ``csrc/device_math.cuh``
    (``pg_bvh_walk``), built on the BVH's device from its tensors and the
    triangles (T, 3) it indexes.  Record 0 of ``packed_nodes`` holds the
    root's box and reference; record k >= 1 the k-th inner node in node
    order: child 0's box, child 1's box, their references.  A reference is
    an inner node's record, or -(8 * start + count) for a leaf of ``count``
    (at most MAX_LEAF) triangles from ``start`` of ``packed_tris``, which
    holds p0, e1, e2 and the original id of each triangle in ``prim_idx``
    order.  Integers are stored as their int32 bits."""
    dev = bvh.child0.device
    child0, child1 = bvh.child0.long(), bvh.child1.long()
    inner = child0 >= 0
    start = -(child0 + 1)
    count = (-child1).clamp(0, MAX_LEAF)
    ref = torch.where(inner, torch.cumsum(inner.long(), 0), -(8 * start + count)).to(torch.int32)
    ids = torch.nonzero(inner).flatten()
    c0, c1 = child0[ids], child1[ids]
    nodes = torch.zeros((ids.numel() + 1, NODE_WORDS), dtype=torch.float32, device=dev)
    nodes[0, 0:3], nodes[0, 3:6] = bvh.node_min[0], bvh.node_max[0]
    nodes[1:, 0:3], nodes[1:, 3:6] = bvh.node_min[c0], bvh.node_max[c0]
    nodes[1:, 6:9], nodes[1:, 9:12] = bvh.node_min[c1], bvh.node_max[c1]
    words = nodes.view(torch.int32)
    words[0, 12] = ref[0]
    words[1:, 12], words[1:, 13] = ref[c0], ref[c1]
    pidx = bvh.prim_idx.long()
    tris = torch.zeros((pidx.numel(), TRI_WORDS), dtype=torch.float32, device=dev)
    tris[:, 0:3], tris[:, 3:6], tris[:, 6:9] = p0[pidx], e1[pidx], e2[pidx]
    tris.view(torch.int32)[:, 9] = bvh.prim_idx.to(torch.int32)
    return bvh._replace(packed_nodes=nodes, packed_tris=tris)
