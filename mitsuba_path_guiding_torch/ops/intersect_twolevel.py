"""Two-level superblock intersector: Morton-sorted blocks of 128
triangles, 64 blocks to a superblock, a per-(ray tile, superblock) mask
and a per-block box gate before a dense Moeller-Trumbore.

Port of ``mitsuba_path_guiding_tpu/ops/intersect_twolevel.py``.
``build_blocks`` (numpy) Morton-sorts the triangles and packs them as
the reference does, bit for bit.  Stage A, ``superblock_mask`` (torch
ops), slab-tests every ray against every superblock box and gives the
(tiles, S) activity mask of 512-ray tiles and the global near-to-far
superblock ``order`` (stable argsort of the mean entry distance over the
rays that enter each box).  Stage B, the kernel
(``csrc/intersect_twolevel.cu``), walks each tile's active superblocks in
that order; per block it gates every ray of the tile against the block's
box with the ray's current best t, ORs the gates over the tile, and when
any ray passes, tests all 512 rays against the block's 128 triangles.
Within a block the least t wins, then the least original id; across
blocks only a strictly nearer t replaces the best.

On a CUDA tensor ``intersect_blocks`` launches the kernel and counts the
launch in ``build.LAUNCHES["intersect_twolevel"]``; on a CPU tensor it
runs ``twolevel_plain``, which walks superblocks and blocks in the
kernel's order, vectorised over tiles.  Both return per-tile work
counts: superblocks walked, blocks opened, triangle tests run (512 x 128
per opened block) and the tests the data needed (per opened block, the
rays whose own gate passed and whose t still admits a hit, times the
block's real triangles).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.ops.intersect_blocklist import mt_block, spread3, unsort

RAY_TILE = 512
TRI_TILE = 128
SB_BLOCKS = 64                   # blocks per superblock
SB_TRIS = SB_BLOCKS * TRI_TILE   # 8192 triangles per superblock
INF = 3.0e38
EPS_T = 1e-4

_FN: dict = {}


class BlockTable(NamedTuple):
    """Tables of ``build_blocks``."""

    tri_pack: torch.Tensor  # (S, 16, SB_TRIS) f32: rows p0 e1 e2, row 9
    #                         the original triangle id (-1 padding)
    blk_lo: torch.Tensor    # (3, Bpad) per-block box min (INF if empty)
    blk_hi: torch.Tensor    # (3, Bpad) per-block box max (-INF if empty)
    sb_lo: torch.Tensor     # (S, 3) superblock box
    sb_hi: torch.Tensor     # (S, 3)


def _morton3(x: np.ndarray) -> np.ndarray:
    """(T, 3) centroids in [0, 1) -> 30-bit Morton codes."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def build_blocks(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray, device=None) -> BlockTable:
    """Host side: Morton-sort the triangles and pack blocks, superblocks
    and their boxes; the tensors go to ``device`` (default the CPU)."""
    p0 = np.asarray(p0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    t = p0.shape[0]
    cent = p0 + (e1 + e2) / 3.0
    lo = cent.min(axis=0)
    ext = np.maximum(cent.max(axis=0) - lo, 1e-9)
    order = np.argsort(_morton3((cent - lo) / ext), kind="stable")

    n_sb = max((t + SB_TRIS - 1) // SB_TRIS, 1)
    tpad = n_sb * SB_TRIS
    bpad = n_sb * SB_BLOCKS

    pack = np.zeros((16, tpad), np.float32)
    pack[9, :] = -1.0
    pack[0:3, :t] = p0[order].T
    pack[3:6, :t] = e1[order].T
    pack[6:9, :t] = e2[order].T
    pack[9, :t] = order.astype(np.float32)
    pack = np.ascontiguousarray(pack.reshape(16, n_sb, SB_TRIS).transpose(1, 0, 2))

    v0 = p0[order]
    v1 = v0 + e1[order]
    v2 = v0 + e2[order]
    tri_lo = np.minimum(np.minimum(v0, v1), v2)
    tri_hi = np.maximum(np.maximum(v0, v1), v2)

    blk_lo = np.full((bpad, 3), INF, np.float32)
    blk_hi = np.full((bpad, 3), -INF, np.float32)
    for b in range((t + TRI_TILE - 1) // TRI_TILE):
        s = slice(b * TRI_TILE, min((b + 1) * TRI_TILE, t))
        blk_lo[b] = tri_lo[s].min(axis=0)
        blk_hi[b] = tri_hi[s].max(axis=0)
    sb_lo = blk_lo.reshape(n_sb, SB_BLOCKS, 3).min(axis=1)
    sb_hi = blk_hi.reshape(n_sb, SB_BLOCKS, 3).max(axis=1)

    dev = torch.device("cpu") if device is None else device
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return BlockTable(tri_pack=as_t(pack), blk_lo=as_t(blk_lo.T), blk_hi=as_t(blk_hi.T),
                      sb_lo=as_t(sb_lo), sb_hi=as_t(sb_hi))


def _gate_inv(d):
    """1 / d with |d| < 1e-12 replaced by +1e-12 (the sign is lost)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-12, 1e-12, d)


def superblock_mask(bt: BlockTable, o, d, tmax):
    """Stage A: ((tiles, S) int32 mask, 1 where some ray of the 512-ray
    tile enters the superblock box within [0, tmax]; (S,) int32 order of
    the superblocks by mean entry distance over the rays that enter).
    Padding rays (d = 1, tmax -1) enter no box."""
    n = o.shape[0]
    npad = ((n + RAY_TILE - 1) // RAY_TILE) * RAY_TILE
    pad = npad - n
    o_p = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=o.device)])
    d_p = torch.cat([d, torch.ones((pad, 3), dtype=d.dtype, device=d.device)])
    tm = torch.cat([tmax, torch.full((pad,), -1.0, dtype=tmax.dtype, device=tmax.device)])
    inv = _gate_inv(d_p)
    lo, hi = bt.sb_lo, bt.sb_hi                                       # (S, 3)

    def slab(a):
        t0 = (lo[:, a][:, None] - o_p[:, a][None, :]) * inv[:, a][None, :]
        t1 = (hi[:, a][:, None] - o_p[:, a][None, :]) * inv[:, a][None, :]
        return torch.minimum(t0, t1), torch.maximum(t0, t1)

    l0, h0 = slab(0)
    l1, h1 = slab(1)
    l2, h2 = slab(2)
    tn = torch.maximum(torch.maximum(l0, l1), torch.clamp_min(l2, 0.0))
    tf = torch.minimum(torch.minimum(h0, h1), h2)
    hit = (tf >= tn) & (tn <= tm[None, :])                             # (S, Npad)
    s = lo.shape[0]
    tiles = hit.reshape(s, npad // RAY_TILE, RAY_TILE).any(dim=-1)     # (S, tiles)
    cnt = hit.sum(dim=1)
    tsum = torch.where(hit, torch.clamp_min(tn, 0.0), 0.0).sum(dim=1)
    mean_tn = torch.where(cnt > 0, tsum / torch.clamp_min(cnt, 1), INF)
    order = torch.argsort(mean_tn, stable=True).to(torch.int32)
    return tiles.T.contiguous().to(torch.int32), order


def _pad_rays(o, d, tmax):
    """Rays as the kernel reads them: (6, Npad) rows o, d and (Npad,)
    tmax; padding rays are zeros with tmax 0."""
    n = o.shape[0]
    npad = ((n + RAY_TILE - 1) // RAY_TILE) * RAY_TILE
    ray = torch.zeros((6, npad), dtype=torch.float32, device=o.device)
    ray[0:3, :n] = o.T
    ray[3:6, :n] = d.T
    tmax_p = torch.zeros((npad,), dtype=torch.float32, device=o.device)
    tmax_p[:n] = tmax
    return ray, tmax_p


def twolevel_plain(bt: BlockTable, ray, tmax_p, mask, order):
    """Plain version of the kernel on padded rays (``_pad_rays``) of
    ``mask.shape[0]`` tiles.  Returns (out (4, Npad) rows t, prim, u, v as
    the kernel leaves them; work (tiles, 4) int64: superblocks walked,
    blocks opened, triangle tests run, triangle tests needed)."""
    npad = ray.shape[1]
    nt = npad // RAY_TILE
    dev = ray.device
    r = ray.reshape(6, nt, RAY_TILE)
    inv = _gate_inv(r[3:6])
    out = torch.zeros((4, nt, RAY_TILE), dtype=torch.float32, device=dev)
    out[0] = torch.clamp_max(tmax_p, INF).reshape(nt, RAY_TILE)
    out[1] = -1.0
    work = torch.zeros((nt, 4), dtype=torch.int64, device=dev)
    n_sb = bt.tri_pack.shape[0]
    real = (bt.tri_pack[:, 9, :] >= 0.0).reshape(n_sb, SB_BLOCKS, TRI_TILE).sum(dim=2)
    lo = bt.blk_lo.T.tolist()
    hi = bt.blk_hi.T.tolist()
    for s in order.tolist():
        tiles = torch.nonzero(mask[:, s] > 0).flatten()
        if tiles.numel() == 0:
            continue
        work[tiles, 0] += 1
        rr, iv = r[:, tiles], inv[:, tiles]                            # (6|3, A, 512)
        for k in range(SB_BLOCKS):
            kb = s * SB_BLOCKS + k
            cur = out[0, tiles]                                        # (A, 512)
            lh = []
            for a in range(3):
                t0 = (lo[kb][a] - rr[a]) * iv[a]
                t1 = (hi[kb][a] - rr[a]) * iv[a]
                lh.append((torch.minimum(t0, t1), torch.maximum(t0, t1)))
            tn = torch.maximum(torch.maximum(lh[0][0], lh[1][0]), torch.clamp_min(lh[2][0], 0.0))
            tf = torch.minimum(torch.minimum(lh[0][1], lh[1][1]), lh[2][1])
            gate = (tf >= tn) & (tn <= cur)
            sel = torch.nonzero(gate.any(dim=1)).flatten()
            if sel.numel() == 0:
                continue
            ti = tiles[sel]
            work[ti, 1] += 1
            work[ti, 2] += RAY_TILE * TRI_TILE
            work[ti, 3] += (gate[sel] & (cur[sel] > EPS_T)).sum(dim=1) * real[s, k]
            tri = bt.tri_pack[s, 0:10, k * TRI_TILE:(k + 1) * TRI_TILE]
            t_b, p_b, u_b, v_b = mt_block(tri[None].expand(sel.numel(), 10, TRI_TILE),
                                          rr[:, sel], False)
            take = t_b < cur[sel]
            for row, val in ((0, t_b), (1, p_b), (2, u_b), (3, v_b)):
                out[row, ti] = torch.where(take, val, out[row, ti])
    return out.reshape(4, npad), work


def _kernel_fn():
    f = _FN.get("closest")
    if f is None:
        f = build.load("intersect_twolevel").twolevel_closest
        # (mask (nt, S), order (S,), S, blk_lo (3, Bpad), blk_hi, Bpad,
        #  ray (6, npad), tmax, npad, tri_pack (S, 16, 8192), out (4, npad),
        #  work (nt, 4) int64, stream)
        f.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p])
        f.restype = ctypes.c_int
        _FN["closest"] = f
    return f


def twolevel_cuda(bt: BlockTable, ray, tmax_p, mask, order):
    """Launch the CUDA kernel; the contract of ``twolevel_plain``."""
    build.refuse_grad("intersect_twolevel", *bt, ray)
    tensors = (*bt, ray, tmax_p, mask, order)
    if not all(x.is_cuda for x in tensors):
        raise ValueError("intersect_twolevel: all tensors must be on the card")
    npad = ray.shape[1]
    nt = npad // RAY_TILE
    n_sb = bt.tri_pack.shape[0]
    bpad = n_sb * SB_BLOCKS
    if npad % RAY_TILE or ray.shape != (6, npad) or tmax_p.shape != (npad,):
        raise ValueError("intersect_twolevel: rays must be (6, Npad) in tiles of 512")
    if tuple(bt.tri_pack.shape[1:]) != (16, SB_TRIS) or tuple(bt.blk_lo.shape) != (3, bpad) \
            or tuple(bt.blk_hi.shape) != (3, bpad):
        raise ValueError("intersect_twolevel: bad block tables")
    if mask.dtype != torch.int32 or order.dtype != torch.int32 or mask.shape != (nt, n_sb) \
            or order.shape != (n_sb,):
        raise TypeError("intersect_twolevel: mask (tiles, S) and order (S,) must be int32")
    if any(x.dtype != torch.float32 for x in (*bt, ray, tmax_p)):
        raise TypeError("intersect_twolevel: expected float32 rays and tables")
    # the kernel reads these while it runs: keep every buffer referenced
    ray, tmax_p, mask, order = (x.contiguous() for x in (ray, tmax_p, mask, order))
    tri_pack, blk_lo, blk_hi = (x.contiguous() for x in (bt.tri_pack, bt.blk_lo, bt.blk_hi))
    out = torch.empty((4, npad), dtype=torch.float32, device=ray.device)
    work = torch.empty((nt, 4), dtype=torch.int64, device=ray.device)
    args = (build.ptr(mask), build.ptr(order), n_sb, build.ptr(blk_lo), build.ptr(blk_hi),
            bpad, build.ptr(ray), build.ptr(tmax_p), npad, build.ptr(tri_pack),
            build.ptr(out), build.ptr(work), build.stream_ptr(ray.device))
    build.check(_kernel_fn()(*args), "intersect_twolevel")
    build.LAUNCHES["intersect_twolevel"] += 1
    return out, work


def twolevel_run(bt: BlockTable, o, d, tmax):
    """Pad, stage A and the kernel (CUDA) or its plain version (CPU).
    Returns (out (4, Npad), work (tiles, 4))."""
    ray, tmax_p = _pad_rays(o, d, tmax)
    mask, order = superblock_mask(bt, o, d, tmax)
    fn = twolevel_cuda if o.is_cuda else twolevel_plain
    return fn(bt, ray, tmax_p, mask, order)


def intersect_blocks(bt: BlockTable, o, d, tmax):
    """Closest hit: (t, prim int32, u, v, valid), the Hit contract of
    accel/traverse.py."""
    n = o.shape[0]
    out = twolevel_run(bt, o, d, tmax)[0]
    t, prim_f = out[0, :n], out[1, :n]
    valid = (prim_f >= 0.0) & (t < INF)
    return (torch.where(valid, t, INF), torch.where(valid, prim_f, -1.0).to(torch.int32),
            out[2, :n], out[3, :n], valid)


def _ray_sort_keys(bt: BlockTable, o, d):
    """int32 key: the Morton code of the origin's cell (6 bits per axis in
    the scene box), then the direction octant in the low 3 bits."""
    lo = torch.min(bt.sb_lo, dim=0).values
    hi = torch.max(bt.sb_hi, dim=0).values
    q = torch.clamp((o - lo) / torch.clamp_min(hi - lo, 1e-9), 0.0, 1.0 - 1e-6)
    cell = (q * 64.0).to(torch.int32)
    m = (spread3(cell[:, 0]) << 2) | (spread3(cell[:, 1]) << 1) | spread3(cell[:, 2])
    octant = ((d[:, 0] >= 0).to(torch.int32) * 4 + (d[:, 1] >= 0).to(torch.int32) * 2
              + (d[:, 2] >= 0).to(torch.int32))
    return (m << 3) | octant


def intersect_blocks_sorted(bt: BlockTable, o, d, tmax):
    """Sort the rays by ``_ray_sort_keys`` (stable), intersect, scatter
    the results back to ray order."""
    perm = torch.argsort(_ray_sort_keys(bt, o, d), stable=True)
    return unsort(perm, *intersect_blocks(bt, o[perm], d[perm], tmax[perm]))
