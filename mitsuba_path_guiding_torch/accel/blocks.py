"""SAH-treelet block decomposition for the blocklist intersector (port of
the reference's accel/blocks.py).

The scene's BVH is cut into treelet blocks of at most 128 triangles, each
a BVH subtree with an SAH-tight box; 32 consecutive blocks (DFS order,
which is spatial order) make a superblock.  The tables are built host-side
in numpy, with the reference's arithmetic, so they equal its tables bit
for bit.
"""
from __future__ import annotations

import numpy as np

from mitsuba_path_guiding_torch.scene.types import BlockList

BLOCK_TRIS = 128  # triangles per treelet block
SB_BLOCKS = 32    # blocks per superblock
INF = 3.0e38


def _subtree_ranges(child0: np.ndarray, child1: np.ndarray):
    """Per-node (prim_start, prim_count) of the flattened BVH, resolved
    bottom-up one tree level per vectorised pass."""
    leaf = child0 < 0
    start = np.where(leaf, -(child0 + 1), 0).astype(np.int64)
    count = np.where(leaf, -child1, 0).astype(np.int64)
    done = leaf.copy()
    c0 = np.where(leaf, 0, child0)
    c1 = np.where(leaf, 0, child1)
    for _ in range(64):
        if done.all():
            break
        ready = ~done & done[c0] & done[c1]
        if not ready.any():
            raise ValueError("BVH child graph is not a tree")
        start[ready] = np.minimum(start[c0[ready]], start[c1[ready]])
        count[ready] = count[c0[ready]] + count[c1[ready]]
        done |= ready
    else:
        raise ValueError("BVH deeper than 64 levels")
    return start, count


def cut_treelets(child0: np.ndarray, child1: np.ndarray, max_tris: int = BLOCK_TRIS):
    """DFS cut of the BVH into subtrees of <= max_tris prims: a list of
    contiguous (prim_start, prim_count) ranges of ``prim_idx``, in DFS
    order."""
    start, count = _subtree_ranges(child0, child1)
    out = []
    stack = [0]
    while stack:
        node = stack.pop()
        if count[node] <= max_tris or child0[node] < 0:
            out.append((int(start[node]), int(count[node])))
        else:
            # push right first so that left pops first
            stack.append(int(child1[node]))
            stack.append(int(child0[node]))
    return out


def tri_boxes(p0, e1, e2, flat):
    """Per-slot triangle boxes of a padded id list (-1 = padding, an
    inverted box): returns (safe ids, lo, hi)."""
    safe = np.maximum(flat, 0)
    v0 = p0[safe]
    v1 = v0 + e1[safe]
    v2 = v0 + e2[safe]
    valid = (flat >= 0)[:, None]
    lo = np.where(valid, np.minimum(np.minimum(v0, v1), v2), INF)
    hi = np.where(valid, np.maximum(np.maximum(v0, v1), v2), -INF)
    return safe, lo, hi


def build_blocklist(p0, e1, e2, bvh) -> BlockList:
    """Host-side tables (numpy arrays) from the triangles and their BVH
    (numpy arrays, accel/bvh.py)."""
    p0, e1, e2 = (np.asarray(a, np.float32) for a in (p0, e1, e2))
    prim_idx = np.asarray(bvh.prim_idx)
    ranges = cut_treelets(np.asarray(bvh.child0), np.asarray(bvh.child1))
    n_blk = len(ranges)
    n_sb = max((n_blk + SB_BLOCKS - 1) // SB_BLOCKS, 1)
    bpad = n_sb * SB_BLOCKS

    ids = np.full((bpad, BLOCK_TRIS), -1, np.int64)
    for b, (s, c) in enumerate(ranges):
        ids[b, :c] = prim_idx[s: s + c]
    flat = ids.reshape(-1)
    safe, tlo, thi = tri_boxes(p0, e1, e2, flat)
    pack = np.zeros((16, bpad * BLOCK_TRIS), np.float32)
    pack[0:3] = p0[safe].T
    pack[3:6] = e1[safe].T
    pack[6:9] = e2[safe].T
    pack[9] = flat.astype(np.float32)  # -1 marks padding
    pack = np.ascontiguousarray(
        pack.reshape(16, n_sb, SB_BLOCKS, BLOCK_TRIS).transpose(1, 2, 0, 3))

    blk_lo = tlo.reshape(bpad, BLOCK_TRIS, 3).min(axis=1)
    blk_hi = thi.reshape(bpad, BLOCK_TRIS, 3).max(axis=1)
    blk_box = np.zeros((bpad, 8), np.float32)
    blk_box[:, 0:3] = blk_lo
    blk_box[:, 3:6] = blk_hi
    return BlockList(
        tri_pack=pack,
        blk_box=blk_box.reshape(n_sb, SB_BLOCKS, 8),
        sb_lo=blk_lo.reshape(n_sb, SB_BLOCKS, 3).min(axis=1),
        sb_hi=blk_hi.reshape(n_sb, SB_BLOCKS, 3).max(axis=1),
        n_blocks=n_blk,
    )
