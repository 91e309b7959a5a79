"""Tables of the pair intersector (port of the reference's accel/pairs.py).

The scene BVH is cut twice: into superblock subtrees of at most 32*128
triangles, and each of those into blocks of at most 128 triangles, so
both levels have SAH-tight boxes.  Built host-side in numpy with the
reference's arithmetic, so the tables equal its tables bit for bit.  The
transposed box table ``tblT`` holds bf16-outward-rounded values as float32
(the reference stores the same values as bfloat16): any other box values
give other candidate lists.
"""
from __future__ import annotations

import numpy as np

from mitsuba_path_guiding_torch.accel.blocks import _subtree_ranges, tri_boxes
from mitsuba_path_guiding_torch.scene.types import PairTable

INF = 3.0e38


def _two_level_cut(child0, child1, leaf: int, sb_blk: int):
    """Superblock subtrees of <= leaf*sb_blk tris, each cut into blocks of
    <= leaf tris; DFS-adjacent under-filled blocks are merged greedily and
    a subtree with more than sb_blk blocks is split into consecutive
    chunks.  Returns a list of per-superblock lists of (start, count)."""
    start, count = _subtree_ranges(child0, child1)

    def cut(root, max_tris):
        out, stack = [], [root]
        while stack:
            nd = stack.pop()
            if count[nd] <= max_tris or child0[nd] < 0:
                out.append(nd)
            else:
                stack.append(int(child1[nd]))
                stack.append(int(child0[nd]))
        return out

    sbs = []
    for r in cut(0, leaf * sb_blk):
        merged = []
        for s_, c_ in ((int(start[n]), int(count[n])) for n in cut(r, leaf)):
            if merged and merged[-1][1] + c_ <= leaf:
                merged[-1] = (merged[-1][0], merged[-1][1] + c_)
            else:
                merged.append((s_, c_))
        for i in range(0, len(merged), sb_blk):
            sbs.append(merged[i: i + sb_blk])
    return sbs


def build_pair_table(p0, e1, e2, bvh, leaf: int = 128, sb_blk: int = 32) -> PairTable:
    """Host-side tables (numpy arrays) from the triangles and their BVH."""
    p0, e1, e2 = (np.asarray(a, np.float32) for a in (p0, e1, e2))
    prim_idx = np.asarray(bvh.prim_idx)
    sbs = _two_level_cut(np.asarray(bvh.child0), np.asarray(bvh.child1), leaf, sb_blk)
    ranges = []
    for blks in sbs:
        ranges.extend(blks)
        ranges.extend([(0, 0)] * (sb_blk - len(blks)))
    n_sb = max(len(sbs), 1)
    bpad = n_sb * sb_blk

    ids = np.full((bpad, leaf), -1, np.int64)
    for b, (s, c) in enumerate(ranges):
        ids[b, :c] = prim_idx[s: s + c]
    flat = ids.reshape(-1)
    safe, tlo, thi = tri_boxes(p0, e1, e2, flat)

    rows = np.zeros((bpad * leaf, 10), np.float32)
    rows[:, 0:3] = p0[safe]
    rows[:, 3:6] = e1[safe]
    rows[:, 6:9] = e2[safe]
    rows[:, 9] = flat.astype(np.float32)
    tri_rows = np.ascontiguousarray(rows.reshape(bpad, leaf, 10).transpose(0, 2, 1))

    blk_lo = tlo.reshape(bpad, leaf, 3).min(axis=1)
    blk_hi = thi.reshape(bpad, leaf, 3).max(axis=1)
    sb_lo = blk_lo.reshape(n_sb, sb_blk, 3).min(axis=1)
    sb_hi = blk_hi.reshape(n_sb, sb_blk, 3).max(axis=1)
    # empty padding blocks: a degenerate plane pair at +-3e38 with
    # alternating axis signs, which no slab test of a real ray passes
    # (an inverted box would pass when the direction flips the planes)
    empty = ~(flat >= 0).reshape(bpad, leaf).any(axis=1)
    far = np.float32([INF, -INF, INF])
    blk_lo[empty] = far
    blk_hi[empty] = far

    tbl = np.concatenate([blk_lo.reshape(n_sb, sb_blk, 3), blk_hi.reshape(n_sb, sb_blk, 3)],
                         axis=2).reshape(n_sb, sb_blk * 6)
    is_hi = np.zeros((sb_blk, 6), bool)
    is_hi[:, 3:] = True
    tblT = np.where(is_hi.reshape(-1)[:, None], _bf16_ceil(tbl.T), _bf16_floor(tbl.T))

    # Pluecker columns (group-major g*leaf + j) against the ray features
    # [d(0:3), o x d(3:6), o(6:9), 1(9), 0(10:16)]:
    #   g=0..2 edge (a->b): rows 0:3 = a x b, rows 3:6 = b - a
    #   g=3 num: rows 6:9 = -n, row 9 = n.v0;  g=4 den: rows 0:3 = n
    vflat = flat >= 0
    w0 = p0[safe]
    w1 = w0 + e1[safe]
    w2 = w0 + e2[safe]
    nvec = np.cross(e1[safe], e2[safe])
    cols = np.zeros((bpad * leaf, 5, 16), np.float32)
    for g, (a, b) in enumerate(((w0, w1), (w1, w2), (w2, w0))):
        cols[:, g, 0:3] = np.cross(a, b)
        cols[:, g, 3:6] = b - a
    cols[:, 3, 6:9] = -nvec
    cols[:, 3, 9] = (nvec * w0).sum(-1)
    cols[:, 4, 0:3] = nvec
    cols[~vflat] = 0.0  # padding: s = 0, den = 0, always a miss
    tri_cols = np.ascontiguousarray(
        cols.reshape(bpad, leaf, 5, 16).transpose(0, 3, 2, 1).reshape(bpad, 16, 5 * leaf))

    n_tri = int(p0.shape[0])
    prim_loc = np.zeros((max(n_tri, 1),), np.int32)
    prim_loc[flat[vflat]] = np.nonzero(vflat)[0].astype(np.int32)
    return PairTable(
        tri_rows=tri_rows, blk_lo=blk_lo, blk_hi=blk_hi, sb_lo=sb_lo, sb_hi=sb_hi,
        tblT=tblT.astype(np.float32),
        nonempty=np.where(~empty)[0].astype(np.int32),
        tri_cols=tri_cols, prim_loc=prim_loc, tri_flat=rows,
    )


def _bf16_floor(x):
    """Largest bf16 (as f32) <= x, elementwise (finite f32 input)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    hi = b >> 16
    rem = (b & 0xFFFF) != 0
    neg = (b >> 31) != 0
    hi = hi + np.where(neg & rem, np.uint32(1), np.uint32(0))
    return (hi << 16).view(np.float32).reshape(x.shape)


def _bf16_ceil(x):
    """Smallest bf16 (as f32) >= x, elementwise (finite f32 input)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    hi = b >> 16
    rem = (b & 0xFFFF) != 0
    pos = (b >> 31) == 0
    hi = hi + np.where(pos & rem, np.uint32(1), np.uint32(0))
    return (hi << 16).view(np.float32).reshape(x.shape)
