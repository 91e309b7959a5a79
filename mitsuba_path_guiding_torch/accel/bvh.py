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
