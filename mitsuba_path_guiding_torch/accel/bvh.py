"""Host-side binned-SAH BVH builder (port of the reference's accel/bvh.py).

Binned SAH with 16 bins, leaves of at most 4 triangles, built by the
native builder (``accel/native.py``, which needs a C++ compiler; the
reference's numpy builder of the same algorithm is not ported).  The tree
comes back as numpy arrays: the scene compiler cuts its block and pair
tables from them before anything moves to the device
(``scene/builder.py``), so no device readback is ever needed.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_path_guiding_torch.accel.native import build_bvh_native
from mitsuba_path_guiding_torch.scene.types import BVH

MAX_LEAF = 4     # triangles a leaf holds at most (the walk tests no more)
NODE_WORDS = 16  # one packed inner node: both children's boxes and references
TRI_WORDS = 12   # one packed triangle: p0, e1, e2 and its original id


def _box_pad(v0, v1, v2) -> float:
    extent = float((np.maximum(np.maximum(v0, v1), v2).max(axis=0)
                    - np.minimum(np.minimum(v0, v1), v2).min(axis=0)).max())
    return 1e-6 * max(extent, 1.0)


def build_bvh(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> BVH:
    """BVH of numpy arrays from triangle (p0, e1, e2) float32 arrays."""
    node_min, node_max, child0, child1, prim_idx, max_depth = build_bvh_native(
        p0, e1, e2, _box_pad(p0, p0 + e1, p0 + e2))
    return BVH(node_min=node_min, node_max=node_max, child0=child0, child1=child1,
               prim_idx=prim_idx, max_depth=max_depth + 2)


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
