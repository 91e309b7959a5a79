"""Pair-expansion intersector: per-ray (ray, block) work lists run as
block-major dense tiles of 128 pairs against one 128-triangle block.

Port of ``mitsuba_path_guiding_tpu/ops/intersect_pairs.py``.  Everything
around the tile kernels is torch ops, in the reference's order:

  1. superblock candidates: slab tests of every ray against all S
     superblock boxes, packed into monotonic (entry distance | id) int32
     keys; the ksb+1 nearest extracted by iterative min;
  2. block lists: per candidate slot, the superblock's 32 block boxes
     (columns of the bf16-rounded ``tblT``, gathered: the reference's
     one-hot matrix select is exact, so the values are the same) slab-
     tested per ray; the l_blk+1 nearest blocks kept, the (l_blk+1)-th key
     is the dropped bound of the completeness proof (the widths ksb and
     l_blk default to PAIR_KSB and PAIR_L; a call site may pass others);
  3. the (l_blk, N) slots sorted by block id, with 128 dummy pairs per
     non-empty block so that every tile of 128 sorted pairs holds real
     pairs of one block only; with ``cap_factor`` only a prefix of the
     sorted pairs is run;
  4. the tile kernel (``mt_tiles`` or ``plk_tiles``): per pair its best
     (t, prim) in its block.  With ``PAIR_DATA_BF16`` the closest-hit MT
     query gathers its pair rows as bfloat16 and the kernel widens its
     inside tests by ``BF16_SLACK`` (the reference's measurement knob; its
     TPU measurements call it a dead end);
  5. the un-sort (a scatter: the payloads are a permutation of the slots),
     the per-ray min over slots, the exact Moeller-Trumbore re-evaluation
     of the winner and the completeness proof.

A ray is proven when its best hit lies before the entry distance of its
first dropped candidate; the caller re-traces unproven rays through the
blocklist kernel (``accel/traverse.py``).

The tile kernels live in ``csrc/intersect_pairs.cu``.  On a CUDA tensor a
wrapper launches its kernel and counts the launch in ``build.LAUNCHES``; on
a CPU tensor it runs the plain version beside it (``mt_tiles_plain``,
``plk_tiles_plain``), the same arithmetic in the same order.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.scene.types import PairTable

INF = 3.0e38
EPS_T = 1e-4
IMAX = 0x7FFFFFFF
PAIR_KSB = 8   # superblock candidate slots per ray
PAIR_L = 8     # block pair slots per ray
PRE_SLOT = 4   # per-slot nearest blocks kept before the global extract
TILE = 128     # pairs per tile
LEAF = 128     # triangles per block
PLK_EPS = 1e-6  # closest-hit Pluecker inside-test slack (relative)
PLAIN_CHUNK = 256  # tiles per step of the plain versions (bounds memory)
# bf16 pair data, the reference's environment switch: the closest-hit MT
# query gathers its (7, P) pair rows as bfloat16 (half the bytes) and the
# tile test admits u, v >= -BF16_SLACK, u + v <= 1 + BF16_SLACK and
# t in (EPS_T (1 - BF16_SLACK), tmax (1 + BF16_SLACK)); the exact f32
# re-evaluation of the winner keeps confirmed hits exact, and a
# slack-admitted impostor becomes unproven and is re-traced.  Any-hit and
# the Pluecker engine stay f32.  Both are read at call time.
PAIR_DATA_BF16 = os.environ.get("PAIR_DATA_BF16", "0") == "1"
BF16_SLACK = 0.02

_FN: dict = {}


def _pack_key(tn, idx):
    """Monotonic (entry distance | id) key: the top 16 bits of the
    non-negative f32 distance (rounded down), the id in the low 16."""
    b = tn.to(torch.float32).contiguous().view(torch.int32)
    return (b & -65536) | idx.to(torch.int32)


def _pos(tn):
    """max(tn, 0) with +0 for every zero, as XLA's maximum gives it (torch's
    maximum can return -0, whose bits would sort first as a key)."""
    return torch.where(tn > 0.0, tn, 0.0)


def _slab(lo_a, hi_a, oa, da, tn, tf):
    """One axis of the slab test, folded into (tn, tf)."""
    parallel = torch.abs(da) < 1e-12
    inv = 1.0 / torch.where(parallel, 1.0, da)
    t0 = (lo_a - oa) * inv
    t1 = (hi_a - oa) * inv
    lo_t = torch.minimum(t0, t1)
    hi_t = torch.maximum(t0, t1)
    inside = (oa >= lo_a) & (oa <= hi_a)
    lo_t = torch.where(parallel, torch.where(inside, 0.0, INF), lo_t)
    hi_t = torch.where(parallel, torch.where(inside, INF, -INF), hi_t)
    return torch.maximum(tn, lo_t), torch.minimum(tf, hi_t)


def _slab_keys(lo, hi, o, d, tmax, ids):
    """Packed entry keys (M, N) of N rays against M boxes; IMAX on a miss."""
    tn = torch.zeros((lo.shape[0], o.shape[0]), dtype=torch.float32, device=o.device)
    tf = torch.full_like(tn, INF)
    for a in range(3):
        tn, tf = _slab(lo[:, a][:, None], hi[:, a][:, None], o[:, a][None, :],
                       d[:, a][None, :], tn, tf)
    tn = _pos(tn)
    hit = (tf >= tn) & (tn <= tmax[None, :])
    return torch.where(hit, _pack_key(tn, ids[:, None]), IMAX)


def _extract_min(keys, k):
    """The k ascending minima along axis 0 of keys (M, N), unique per
    column, -> (k, N)."""
    outs = []
    for _ in range(k):
        m = torch.min(keys, dim=0).values
        outs.append(m)
        keys = torch.where(keys == m[None, :], IMAX, keys)
    return torch.stack(outs)


def build_pair_lists(pt: PairTable, o, d, tmax, ksb: int = PAIR_KSB, l_blk: int = PAIR_L):
    """Stages 1-2: per-ray nearest-l_blk block lists from the ksb nearest
    superblocks.  Returns (ids (l_blk, N) int32, -1 for an empty slot;
    dropped (N,) int32, the packed entry key of the first candidate not in
    the list, IMAX if none)."""
    n = o.shape[0]
    s = pt.sb_lo.shape[0]
    dev = o.device
    sb_keys = _slab_keys(pt.sb_lo, pt.sb_hi, o, d, tmax,
                         torch.arange(s, dtype=torch.int32, device=dev))
    sb_min = _extract_min(sb_keys, ksb + 1)
    sb_dropped = sb_min[ksb]
    nb = pt.sb_blk
    blk_iota = torch.arange(nb, dtype=torch.int32, device=dev)[:, None]
    key_rows = []
    for k in range(ksb):
        slot = sb_min[k]
        slot_valid = slot != IMAX
        sid = torch.where(slot_valid, slot & 0xFFFF, -1)
        # an empty slot reads superblock 0's boxes; its keys are masked below
        gt = pt.tblT[:, sid.clamp_min(0).long()].reshape(nb, 6, n)
        tn = torch.zeros((nb, n), dtype=torch.float32, device=dev)
        tf = torch.full_like(tn, INF)
        for a in range(3):
            tn, tf = _slab(gt[:, a, :], gt[:, 3 + a, :], o[:, a][None, :], d[:, a][None, :],
                           tn, tf)
        tn = _pos(tn)
        hit = (tf >= tn) & (tn <= tmax[None, :]) & slot_valid[None, :]
        gids = sid.clamp_min(0)[None, :] * nb + blk_iota
        # keep each slot's PRE_SLOT nearest blocks and its dropped bound
        key_rows.append(_extract_min(torch.where(hit, _pack_key(tn, gids), IMAX),
                                     PRE_SLOT + 1))
    pre = torch.cat(key_rows, dim=0).reshape(ksb, PRE_SLOT + 1, n)
    per_slot_dropped = pre[:, PRE_SLOT, :]
    kept = pre[:, :PRE_SLOT, :].reshape(ksb * PRE_SLOT, n)
    blk_min = _extract_min(kept, l_blk + 1)
    blk_dropped = torch.minimum(blk_min[l_blk], torch.min(per_slot_dropped, dim=0).values)
    dropped = torch.minimum(sb_dropped, blk_dropped)
    ids = torch.where(blk_min[:l_blk] == IMAX, -1, blk_min[:l_blk] & 0xFFFF)
    return ids, dropped


# ---------------------------------------------------------------------------
# tile kernels and their plain versions
# ---------------------------------------------------------------------------

def _tile_chunks(n_tiles):
    for a in range(0, n_tiles, PLAIN_CHUNK):
        yield a, min(a + PLAIN_CHUNK, n_tiles)


def _f32(x: float) -> float:
    return float(np.float32(x))


def loose_bounds():
    """The float32 constants of the loose inside test of bf16 pair data,
    from BF16_SLACK s at call time, rounded as the reference's weak-typed
    Python scalars round them: (neg, one, eps_lo, u_hi) = (-s, 1 + s,
    EPS_T (1 - s), one - neg + 2^-7).  The kernel and the plain version
    both take them from here; only the kernel's first stage reads u_hi
    (device_math.cuh pg_mt_u_loose)."""
    s = BF16_SLACK
    neg, one = _f32(-s), _f32(1.0 + s)
    return neg, one, _f32(EPS_T * (1.0 - s)), _f32(one - neg + 2.0 ** -7)


def _mt_tile_chunk(tri, pd, any_hit):
    """Dense Moeller-Trumbore of one chunk: tri (T, 10, 128) blocks, pd
    (7, T, 128) pair rows [o, d, tmax], float32 or bfloat16 (upcast once,
    then the loose test of ``loose_bounds``).  Returns (t_best, prim)
    (T, 128) in the Pallas kernel's output convention."""
    loose = pd.dtype == torch.bfloat16
    pd = pd.float()

    def tcol(c):
        return tri[:, c, :][:, :, None]   # (T, 128 tris, 1)

    def rrow(c):
        return pd[c][:, None, :]          # (T, 1, 128 pairs)

    p0x, p0y, p0z = tcol(0), tcol(1), tcol(2)
    e1x, e1y, e1z = tcol(3), tcol(4), tcol(5)
    e2x, e2y, e2z = tcol(6), tcol(7), tcol(8)
    tid = tcol(9)
    ox, oy, oz = rrow(0), rrow(1), rrow(2)
    dx, dy, dz = rrow(3), rrow(4), rrow(5)
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(torch.abs(det) < 1e-12, 0.0, 1.0 / torch.where(det == 0.0, 1.0, det))
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    if loose:
        neg, one, eps_lo, _ = loose_bounds()
        hit = ((inv_det != 0.0) & (u >= neg) & (v >= neg) & (u + v <= one) & (t > eps_lo)
               & (t < rrow(6) * one) & (tid >= 0.0))
    else:
        hit = ((inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS_T)
               & (t < rrow(6)) & (tid >= 0.0))
    return _best(torch.where(hit, t, INF), tid, any_hit)


def _best(t, tid, any_hit):
    """Per pair: the least t over the triangle axis (1) and, among equal
    t, the least triangle id; (INF, -1) for a miss, +-1 for any-hit."""
    t_best = torch.min(t, dim=1).values
    if any_hit:
        return t_best, torch.where(t_best < INF, 1.0, -1.0)
    prim = torch.min(torch.where(t == t_best[:, None, :], tid, 2.0e9), dim=1).values
    return t_best, torch.where(t_best < INF, prim, -1.0)


def mt_tiles_plain(tri_rows, tile_block, pdata, any_hit: bool):
    """Plain version of the MT tile kernel.  tri_rows (B, 10, 128);
    tile_block (T,) int32 (< 0: inert tile); pdata (7, T*128) rows o, d,
    tmax (0 for dead pairs), float32, or bfloat16 for a closest hit with
    the loose test of ``loose_bounds``.  Returns (2, T*128): best t and the
    prim as float (closest) or +-1 (any-hit); (INF, -1) for a miss or
    inert tile."""
    if any_hit and pdata.dtype == torch.bfloat16:
        raise ValueError("mt_tiles: bf16 pair data is for closest hits only (any-hit stays "
                         "float32, as in the reference)")
    n_tiles = tile_block.shape[0]
    out = torch.empty((2, n_tiles * TILE), dtype=torch.float32, device=pdata.device)
    for a, b in _tile_chunks(n_tiles):
        blk = tile_block[a:b]
        tri = tri_rows[blk.clamp_min(0).long()]
        t_b, p_b = _mt_tile_chunk(tri, pdata[:, a * TILE: b * TILE].reshape(7, b - a, TILE),
                                  any_hit)
        inert = (blk < 0)[:, None]
        out[0, a * TILE: b * TILE] = torch.where(inert, INF, t_b).reshape(-1)
        out[1, a * TILE: b * TILE] = torch.where(inert, -1.0, p_b).reshape(-1)
    return out


def plk_coeffs(tri_cols):
    """(B, 16, 5*128) Pluecker columns -> (B, 25, 128) per-triangle
    coefficients in the order device_math.cuh pg_plucker_hit reads them:
    0:18 the three edge sides (rows 0:6 of groups 0-2), 18:22 the plane
    numerator (rows 6:10 of group 3), 22:25 the denominator (rows 0:3 of
    group 4)."""
    g = tri_cols.reshape(tri_cols.shape[0], 16, 5, LEAF)
    return torch.cat([g[:, 0:6, 0], g[:, 0:6, 1], g[:, 0:6, 2], g[:, 6:10, 3], g[:, 0:3, 4]],
                     dim=1)


def _side(c, i, d, m):
    return ((((c[i] * d[0] + c[i + 1] * d[1]) + c[i + 2] * d[2]) + c[i + 3] * m[0])
            + c[i + 4] * m[1]) + c[i + 5] * m[2]


def _plk_tile_chunk(cf, tid, pd, any_hit):
    """Pluecker tiles of one chunk: cf (T, 25, 128) coefficients, tid
    (T, 128) ids, pd (7, T, 128) pair rows.  Sums in pg_plucker_hit's
    order, so the kernel agrees bit for bit."""
    c = [cf[:, i, :][:, :, None] for i in range(25)]
    o = [pd[i][:, None, :] for i in range(3)]
    d = [pd[3 + i][:, None, :] for i in range(3)]
    m = [o[1] * d[2] - o[2] * d[1], o[2] * d[0] - o[0] * d[2], o[0] * d[1] - o[1] * d[0]]
    s0, s1, s2 = _side(c, 0, d, m), _side(c, 6, d, m), _side(c, 12, d, m)
    num = ((c[18] * o[0] + c[19] * o[1]) + c[20] * o[2]) + c[21]
    den = (c[22] * d[0] + c[23] * d[1]) + c[24] * d[2]
    smin = torch.minimum(torch.minimum(s0, s1), s2)
    smax = torch.maximum(torch.maximum(s0, s1), s2)
    if any_hit:
        inside = (smin >= 0.0) | (smax <= 0.0)
    else:
        eps = PLK_EPS * ((torch.abs(s0) + torch.abs(s1)) + torch.abs(s2))
        inside = (smin >= -eps) | (smax <= eps)
    ok_den = den != 0.0
    t = num / torch.where(ok_den, den, 1.0)
    tid = tid[:, :, None]
    hit = inside & ok_den & (t > EPS_T) & (t < pd[6][:, None, :]) & (tid >= 0.0)
    return _best(torch.where(hit, t, INF), tid, any_hit)


def plk_tiles_plain(tri_cols, tri_rows, tile_block, pdata, any_hit: bool):
    """Plain version of the Pluecker tile kernel; the contract of
    ``mt_tiles_plain``, with tri_cols (B, 16, 5*128) for the triangles."""
    n_tiles = tile_block.shape[0]
    out = torch.empty((2, n_tiles * TILE), dtype=torch.float32, device=pdata.device)
    for a, b in _tile_chunks(n_tiles):
        blk = tile_block[a:b]
        bi = blk.clamp_min(0).long()
        t_b, p_b = _plk_tile_chunk(plk_coeffs(tri_cols[bi]), tri_rows[bi, 9, :],
                                   pdata[:, a * TILE: b * TILE].reshape(7, b - a, TILE), any_hit)
        inert = (blk < 0)[:, None]
        out[0, a * TILE: b * TILE] = torch.where(inert, INF, t_b).reshape(-1)
        out[1, a * TILE: b * TILE] = torch.where(inert, -1.0, p_b).reshape(-1)
    return out


def _kernel_fn(engine: str, any_hit: bool, bf16: bool = False):
    key = f"pair_{engine}_{'any' if any_hit else 'closest'}{'_bf16' if bf16 else ''}"
    f = _FN.get(key)
    if f is None:
        f = getattr(build.load("intersect_pairs"), key)
        # (table, tri_rows, n_blocks, tile_block, n_tiles, pdata, out, stream
        # [, the four floats of loose_bounds])
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p
                      ] + [ctypes.c_float] * (4 if bf16 else 0)
        f.restype = ctypes.c_int
        _FN[key] = f
    return f


def _launch(engine, table, tri_rows, tile_block, pdata, any_hit):
    if not any_hit:
        build.refuse_grad(f"intersect_pairs {engine}", table, tri_rows, pdata)
    n_tiles = tile_block.shape[0]
    if not (table.is_cuda and tile_block.is_cuda and pdata.is_cuda):
        raise ValueError(f"{engine}_tiles: all tensors must be on the card")
    bf16 = pdata.dtype == torch.bfloat16
    if bf16 and (engine != "mt" or any_hit):
        raise TypeError(f"{engine}_tiles: bf16 pair data is for the MT closest hit only")
    if table.dtype != torch.float32 or pdata.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{engine}_tiles: expected float32 tables and float32 or bfloat16 "
                        "pair data")
    if tile_block.dtype != torch.int32 or tile_block.dim() != 1:
        raise TypeError(f"{engine}_tiles: tile_block must be (T,) int32")
    if pdata.shape != (7, n_tiles * TILE):
        raise ValueError(f"{engine}_tiles: pair data {tuple(pdata.shape)}, expected "
                         f"(7, {n_tiles * TILE})")
    if n_tiles * TILE >= 2**31:
        raise ValueError(f"{engine}_tiles: too many pairs")
    shape = (10, LEAF) if engine == "mt" else (16, 5 * LEAF)
    for tab, shp in ((table, shape), (tri_rows, (10, LEAF))):
        if tab.dim() != 3 or tuple(tab.shape[1:]) != shp or tab.shape[0] != table.shape[0] \
                or not tab.is_cuda or tab.dtype != torch.float32:
            raise ValueError(f"{engine}_tiles: bad triangle table {tuple(tab.shape)}")
    table, tri_rows = table.contiguous(), tri_rows.contiguous()
    pdata, tile_block = pdata.contiguous(), tile_block.contiguous()
    out = torch.empty((2, n_tiles * TILE), dtype=torch.float32, device=pdata.device)
    stream = build.stream_ptr(pdata.device)
    build.check(_kernel_fn(engine, any_hit, bf16)(build.ptr(table), build.ptr(tri_rows),
                                                   table.shape[0], build.ptr(tile_block),
                                                   n_tiles, build.ptr(pdata), build.ptr(out),
                                                   stream, *(loose_bounds() if bf16 else ())),
                f"intersect_pairs {engine}{' bf16' if bf16 else ''}")
    build.LAUNCHES[f"intersect_pairs_{engine}{'_bf16' if bf16 else ''}"] += 1
    return out


def mt_tiles(tri_rows, tile_block, pdata, any_hit: bool):
    """Stage 4, Moeller-Trumbore tiles (contract of ``mt_tiles_plain``):
    the CUDA kernel for a CUDA tensor (bfloat16 pair data: the bf16 kernel,
    counted as ``intersect_pairs_mt_bf16``), the plain version for a CPU
    one."""
    if pdata.is_cuda:
        return _launch("mt", tri_rows, tri_rows, tile_block, pdata, any_hit)
    return mt_tiles_plain(tri_rows, tile_block, pdata, any_hit)


def plk_tiles(tri_cols, tri_rows, tile_block, pdata, any_hit: bool):
    """Stage 4, Pluecker tiles (contract of ``plk_tiles_plain``)."""
    if pdata.is_cuda:
        return _launch("plk", tri_cols, tri_rows, tile_block, pdata, any_hit)
    return plk_tiles_plain(tri_cols, tri_rows, tile_block, pdata, any_hit)


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def sorted_pairs(pt: PairTable, ids, n: int, cap_factor=None):
    """Stage 3: the block-major pair order.  Returns (skeys, spays,
    cut_rays): the sorted keys (2*block for a real pair, 2*block+1 for a
    dummy, IMAX otherwise) of the prefix that runs, their payloads (flat
    slot index, IMAX for padding), and the rays whose lists reach past the
    cut (None without a cut)."""
    dev = ids.device
    flat_blk = ids.reshape(-1)
    sort_key = torch.where(flat_blk >= 0, flat_blk * 2, IMAX)
    payload = torch.arange(flat_blk.shape[0], dtype=torch.int32, device=dev)
    dummy_key = torch.repeat_interleave(pt.nonempty, TILE) * 2 + 1
    n_dummy = dummy_key.shape[0]
    tail = (-(flat_blk.shape[0] + n_dummy)) % TILE
    keys = torch.cat([sort_key, dummy_key.to(torch.int32),
                      torch.full((tail,), IMAX, dtype=torch.int32, device=dev)])
    pays = torch.cat([payload, torch.full((n_dummy + tail,), IMAX, dtype=torch.int32,
                                          device=dev)])
    skeys, order = torch.sort(keys, stable=True)
    cut_rays = None
    if cap_factor is not None:
        p_cap = cap_factor * n + n_dummy
        p_cap = min(((p_cap + TILE - 1) // TILE) * TILE, skeys.shape[0])
        if p_cap < skeys.shape[0]:
            cut_key = skeys[p_cap]
            cut_blk = torch.where(cut_key == IMAX, IMAX, cut_key // 2)
            cut_rays = torch.any((ids >= 0) & (ids >= cut_blk), dim=0)
            skeys, order = skeys[:p_cap], order[:p_cap]
    return skeys, pays[order], cut_rays


def pair_tiles(skeys, spays, o, d, tmax, bf16: bool = False):
    """Pair rows (7, P) [o, d, tmax; tmax 0 for all but real pairs] and
    the block of each 128-pair tile (-1 for an inert tile).  With ``bf16``
    the (7, N) ray rows are rounded to bfloat16 before the gather, as the
    reference's PAIR_DATA_BF16 path rounds them."""
    n = o.shape[0]
    is_real = (skeys != IMAX) & (skeys % 2 == 0)
    ray_idx = torch.where(spays != IMAX, spays % n, 0).long()
    rows = torch.cat([o.T, d.T, tmax[None, :]], dim=0)
    if bf16:
        rows = rows.to(torch.bfloat16)
    pdata = rows[:, ray_idx]
    pdata[6] = torch.where(is_real, pdata[6], 0.0)
    tk = skeys.reshape(-1, TILE)
    tile_block = torch.max(torch.where((tk != IMAX) & (tk % 2 == 0), tk // 2, -1), dim=1).values
    return pdata, tile_block.to(torch.int32)


def _mt_exact_winner(pt: PairTable, prim, o, d, tmax):
    """Exact Moeller-Trumbore of each ray's winning triangle: (t, u, v, ok)
    in the arithmetic of the brute oracle and the blocklist kernel."""
    from mitsuba_path_guiding_torch.core.math import cross, dot

    loc = pt.prim_loc[prim.clamp(0, pt.prim_loc.shape[0] - 1).long()]
    rows = pt.tri_flat[loc.long()]
    p0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    pv = cross(d, e2)
    det = dot(e1, pv)
    inv_det = torch.where(torch.abs(det) < 1e-12, 0.0, 1.0 / torch.where(det == 0.0, 1.0, det))
    tv = o - p0
    u = dot(tv, pv) * inv_det
    qv = cross(tv, e1)
    v = dot(d, qv) * inv_det
    t = dot(e2, qv) * inv_det
    ok = (inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS_T) & (t < tmax)
    return t, u, v, ok


def _hi16(x):
    return x.contiguous().view(torch.int32) & -65536


def intersect_pairs_raw(pt: PairTable, o, d, tmax, ksb: int = PAIR_KSB, l_blk: int = PAIR_L,
                        any_hit: bool = False, cap_factor=None, engine: str = "mt"):
    """Closest hit (or any-hit) through the pair pipeline.

    Returns (t, prim int32, u, v, valid, proven), or (occluded, proven)
    with ``any_hit``; ``proven`` False marks rays the caller must re-trace.
    ``ksb``, ``l_blk``: the candidate-list widths (superblocks, blocks a
    ray).  ``cap_factor``: run only the first cap_factor*N + dummies sorted
    pairs; rays whose lists reach past the cut are unproven.  ``engine``:
    "mt" (Moeller-Trumbore tiles) or "plk" (Pluecker tiles and the exact
    winner re-evaluation).  With ``PAIR_DATA_BF16`` the MT closest hit runs
    on bf16 pair data (the reference applies it where its Pallas kernel
    runs; the port wherever the tile kernel or its plain version runs)."""
    if engine not in ("mt", "plk"):
        raise ValueError(f"unknown pair engine '{engine}'")
    if pt.leaf != LEAF:
        raise ValueError(f"pair tiles expect blocks of {LEAF} triangles")
    n = o.shape[0]
    ids, dropped = build_pair_lists(pt, o, d, tmax, ksb, l_blk)
    skeys, spays, cut_rays = sorted_pairs(pt, ids, n, cap_factor)
    bf16 = PAIR_DATA_BF16 and not any_hit and engine == "mt"
    pdata, tile_block = pair_tiles(skeys, spays, o, d, tmax, bf16=bf16)
    if engine == "plk":
        res = plk_tiles(pt.tri_cols, pt.tri_rows, tile_block, pdata, any_hit)
    else:
        res = mt_tiles(pt.tri_rows, tile_block, pdata, any_hit)

    # stage 5: un-sort the run prefix into the (l_blk, N) slots; cut and
    # empty slots read as misses
    ln = l_blk * n
    slot = spays < ln
    dst = spays[slot].long()
    t_ray = torch.full((ln,), INF, dtype=torch.float32, device=o.device)
    t_ray[dst] = res[0][slot]
    t_ray = t_ray.reshape(l_blk, n)
    if any_hit:
        occ = torch.any(t_ray < INF, dim=0)
        # a found occluder proves itself; a miss only when nothing closer
        # than tmax was dropped
        proven = occ | (dropped >= _hi16(torch.clamp_min(tmax, 0.0)))
        if cut_rays is not None:
            proven = occ | (proven & ~cut_rays)
        return occ, proven
    prim_ray = torch.full((ln,), -1.0, dtype=torch.float32, device=o.device)
    prim_ray[dst] = res[1][slot]
    prim_ray = prim_ray.reshape(l_blk, n)
    t_best = torch.min(t_ray, dim=0).values
    prim_best = torch.min(torch.where(t_ray == t_best[None, :], prim_ray, 2.0e9), dim=0).values
    hit_valid = t_best < INF
    prim_i = torch.where(hit_valid, prim_best, -1.0).to(torch.int32)
    t_ex, u_ex, v_ex, ok_ex = _mt_exact_winner(pt, prim_i, o, d, tmax)
    confirmed = hit_valid & ok_ex
    t_fin = torch.where(confirmed, t_ex, INF)
    proven = (_hi16(t_fin) <= (dropped & -65536)) & ~(hit_valid & ~ok_ex)
    if cut_rays is not None:
        proven = proven & ~cut_rays
    return (t_fin, torch.where(confirmed, prim_i, -1).to(torch.int32),
            torch.where(confirmed, u_ex, 0.0), torch.where(confirmed, v_ex, 0.0),
            confirmed, proven)
