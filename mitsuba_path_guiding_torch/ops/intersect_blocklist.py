"""Blocklist intersector: per-ray-tile candidate superblock lists walked
near to far with early exit.

Port of ``mitsuba_path_guiding_tpu/ops/intersect_blocklist.py``.  Rays are
padded to tiles of 256 (``_pad_rays``).  Stage A (``candidate_superblocks``,
torch ops) slab-tests each tile's conservative bounds (origin box and
direction interval) against every superblock box and lists the hits by
their conservative entry distance.  Stage B, the kernel
(``csrc/intersect_blocklist.cu``), walks a tile's list while the next
candidate's entry distance does not exceed the worst current best t of
the tile; per superblock it gates each ray against the 32 block boxes
with its best t from before the step, ORs the gates over each half tile
of 128 rays and runs a dense Moeller-Trumbore of the half tile against
every block whose bit is set.  The step's result for a ray is the least
(t, block index, triangle id) over those blocks, taken where strictly
nearer than its best (any-hit: a hit below its t in any of them), so the
visits of a step can run in any order.  A tile whose raw candidate count
exceeds the list width k walks every superblock in index order with no
early exit.

On a CUDA tensor the wrappers launch the kernel and count the launch in
``build.LAUNCHES["intersect_blocklist"]``; on a CPU tensor they run
``blocklist_plain``, which walks tiles and candidates in the kernel's
order, vectorised over tiles, one reduction over all visits per step.
Both also return per-tile work counts:
superblocks walked, (block, half tile) visits, and the triangle tests the
data needed (per visit, the rays of the half tile whose own gate passed
the block and whose t still admits a hit, times the block's real
triangles).

``intersect_blocklist_sorted`` / ``occluded_blocklist_sorted``, the
route of a big scene without pair tables, sort the rays of a wave by a
Morton key of origin cell and direction (``_ray_sort_keys``) before the
call, so that a tile's rays are close in both, and scatter the results
back.
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.scene.types import BlockList

RAY_TILE = 256
SUB_TILE = 128   # gating granularity inside a ray tile
N_SUB = RAY_TILE // SUB_TILE
SB_BLOCKS = 32
BLOCK_TRIS = 128
INF = 3.0e38
EPS_T = 1e-4
MAX_CAND = 128   # candidate-list width (walk-everything above it)
# The reference caps k so that its candidate table fits the TPU's scalar
# memory (768 KB); the cap is kept so that tiles overflow, and so walk
# their superblocks, exactly where the reference's do.
CAND_TABLE_INTS = 768 * 1024 // 4
INF_HI = 0x7F80  # f32 +inf bits >> 16
SORT_POS_BITS = 4  # origin cell bits per axis of the sorted route's key
SORT_DIR_BITS = 5  # direction bits per octahedral component
VISIT_CHUNK = 256  # visits per dense MT of the plain version (~1.6 MB of temporaries each)

_FN: dict = {}


def _pad_rays(o, d, tmax):
    """Pad to a RAY_TILE multiple by repeating the last ray with tmax 0."""
    n = o.shape[0]
    npad = ((n + RAY_TILE - 1) // RAY_TILE) * RAY_TILE
    pad = npad - n
    o_p = torch.cat([o, o[-1:].expand(pad, 3)])
    d_p = torch.cat([d, d[-1:].expand(pad, 3)])
    t_p = torch.cat([tmax, torch.zeros((pad,), dtype=tmax.dtype, device=tmax.device)])
    return o_p, d_p, t_p, npad


def cand_width(npad: int, s: int, k: int = MAX_CAND) -> int:
    """The list width a call of npad rays over s superblocks runs with."""
    nt = npad // RAY_TILE
    k = max(8, min(k, CAND_TABLE_INTS // max(nt, 1)))
    return min(k, s) if s >= 1 else 1


def candidate_superblocks(sb_lo, sb_hi, o, d, tmax, k: int):
    """Stage A on padded rays.  Returns (cand (nt, k) int32 keys
    [entry-distance bits >> 16 << 16 | superblock id], ascending; cnt (nt,)
    int32 raw hit count, which may exceed k)."""
    npad = o.shape[0]
    nt = npad // RAY_TILE
    s = sb_lo.shape[0]
    ot = o.T.reshape(3, nt, RAY_TILE)
    dt = d.T.reshape(3, nt, RAY_TILE)
    olo, ohi = ot.min(dim=2).values.T, ot.max(dim=2).values.T   # (nt, 3)
    dlo, dhi = dt.min(dim=2).values.T, dt.max(dim=2).values.T
    tmx = tmax.reshape(nt, RAY_TILE).max(dim=1).values
    eps = 1e-12
    tn = torch.zeros((nt, s), dtype=torch.float32, device=o.device)
    tf = torch.full((nt, s), INF, dtype=torch.float32, device=o.device)
    for a in range(3):
        con = (dlo[:, a] > eps) | (dhi[:, a] < -eps)
        ilo = (1.0 / torch.where(con, dhi[:, a], 1.0))[:, None]
        ihi = (1.0 / torch.where(con, dlo[:, a], 1.0))[:, None]
        lo_m_lo = sb_lo[:, a][None, :] - ohi[:, a][:, None]
        lo_m_hi = sb_lo[:, a][None, :] - olo[:, a][:, None]
        hi_m_lo = sb_hi[:, a][None, :] - ohi[:, a][:, None]
        hi_m_hi = sb_hi[:, a][None, :] - olo[:, a][:, None]

        def iprod_bounds(x0, x1):
            c = torch.stack([x0 * ilo, x0 * ihi, x1 * ilo, x1 * ihi])
            return c.min(dim=0).values, c.max(dim=0).values

        t0_lo, t0_hi = iprod_bounds(lo_m_lo, lo_m_hi)
        t1_lo, t1_hi = iprod_bounds(hi_m_lo, hi_m_hi)
        tn = torch.maximum(tn, torch.where(con[:, None], torch.minimum(t0_lo, t1_lo), 0.0))
        tf = torch.minimum(tf, torch.where(con[:, None], torch.maximum(t0_hi, t1_hi), INF))
    tn = torch.where(tn > 0.0, tn, 0.0)  # +0 for every zero, as XLA's maximum
    hit = (tf >= tn) & (tn <= tmx[:, None])
    cnt = hit.sum(dim=1).to(torch.int32)
    neg = torch.where(hit, -tn.contiguous().view(torch.int32), torch.iinfo(torch.int32).min)
    # stable descending order = ascending entry distance, ties by id (top_k)
    vals, idx = torch.sort(neg, dim=1, descending=True, stable=True)
    return ((-vals[:, :k]) & -65536) | idx[:, :k].to(torch.int32), cnt


def _tile_rays(o_p, d_p):
    """(6, nt, 256) ray components and the gate reciprocals (3, nt, 256)."""
    nt = o_p.shape[0] // RAY_TILE
    ray = torch.cat([o_p.T, d_p.T], dim=0).reshape(6, nt, RAY_TILE)
    inv = 1.0 / torch.where(torch.abs(ray[3:6]) < 1e-12, 1e-12, ray[3:6])
    return ray, inv


def mt_block(tri, ray, any_hit):
    """Dense MT of rays (6, M, L) against blocks tri (M, 10, 128):
    per ray the block's least t and, among equal t, least id, with its
    u, v (closest), or the per-(tri, ray) hit t (any-hit)."""
    def tcol(c):
        return tri[:, c, :][:, :, None]

    ox, oy, oz, dx, dy, dz = (ray[c][:, None, :] for c in range(6))
    p0x, p0y, p0z = tcol(0), tcol(1), tcol(2)
    e1x, e1y, e1z = tcol(3), tcol(4), tcol(5)
    e2x, e2y, e2z = tcol(6), tcol(7), tcol(8)
    tid = tcol(9)
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
    hit = ((inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS_T)
           & (tid >= 0.0))
    t = torch.where(hit, t, INF)
    if any_hit:
        return t
    t_best = torch.min(t, dim=1).values
    is_best = t == t_best[:, None, :]
    prim = torch.min(torch.where(is_best, tid, 2.0e9), dim=1).values
    first = is_best & (tid == prim[:, None, :])
    return (t_best, prim, torch.sum(torch.where(first, u, 0.0), dim=1),
            torch.sum(torch.where(first, v, 0.0), dim=1))


def _step_visits(bl: BlockList, ray, cur, tiles, sb, bits, any_hit: bool):
    """One superblock step of the tiles ``tiles`` as one reduction over all
    of its (block, half tile) visits ``bits`` (A, 32, 2).  Closest hit:
    per ray the least (t, block index, triangle id) over the visited blocks
    of its half, as (t, prim, u, v) (A, 256) with t INF where no block hit.
    Any-hit: per ray the first visited block holding a hit below ``cur``
    (A, 256), SB_BLOCKS where none does."""
    a = tiles.shape[0]
    dev = ray.device
    va, vb, vs = torch.nonzero(bits, as_tuple=True)                 # visits, any order
    lanes = vs[:, None] * SUB_TILE + torch.arange(SUB_TILE, device=dev)    # (V, 128)
    rows = 1 if any_hit else 4
    per_block = torch.zeros((rows, a, SB_BLOCKS, RAY_TILE), dtype=torch.float32, device=dev)
    per_block[0] = INF
    for c0 in range(0, va.numel(), VISIT_CHUNK):
        ca, cb, cl = va[c0:c0 + VISIT_CHUNK], vb[c0:c0 + VISIT_CHUNK], lanes[c0:c0 + VISIT_CHUNK]
        tri = bl.tri_pack[sb[ca], cb, 0:10, :]                       # (V, 10, 128)
        rr = ray[:, tiles[ca][:, None], cl]                          # (6, V, 128)
        if any_hit:
            got = torch.any(mt_block(tri, rr, True) < cur[ca[:, None], cl][:, None, :], dim=1)
            per_block[0, ca[:, None], cb[:, None], cl] = torch.where(got, 0.0, INF)
        else:
            for row, val in enumerate(mt_block(tri, rr, False)):
                per_block[row, ca[:, None], cb[:, None], cl] = val
    blk = torch.arange(SB_BLOCKS, device=dev)[None, :, None]
    if any_hit:
        return torch.min(torch.where(per_block[0] < INF, blk, SB_BLOCKS), dim=1).values
    # the block's own winner is the least (t, id); among blocks of equal t
    # the least block index
    t_min = per_block[0].min(dim=1).values                              # (A, 256)
    first = torch.min(torch.where(per_block[0] == t_min[:, None], blk, SB_BLOCKS), dim=1).values
    first = torch.clamp_max(first, SB_BLOCKS - 1)[:, None, :]
    return (t_min, *(torch.gather(per_block[r], 1, first)[:, 0] for r in (1, 2, 3)))


def blocklist_plain(bl: BlockList, o_p, d_p, t_p, cand, cnt, any_hit: bool = False,
                    tests_run: bool = False):
    """Plain version of the kernel on padded rays: each superblock step is
    one reduction over all of its visits (``_step_visits``), taken where it
    is strictly nearer than the best from before the step.  Returns (out
    (4, npad) rows t, prim, u, v as the kernel leaves them; work (nt, 3)
    int32 superblocks walked, (block, half tile) visits and needed
    triangle tests); with ``tests_run`` also the triangle tests the visits
    run (nt,) int64: per visit 128 rays times the block's real triangles."""
    npad = o_p.shape[0]
    nt = npad // RAY_TILE
    n_sb = bl.tri_pack.shape[0]
    k = cand.shape[1]
    dev = o_p.device
    ray, inv = _tile_rays(o_p, d_p)
    real = (bl.tri_pack[:, :, 9, :] >= 0.0).sum(dim=2, dtype=torch.int32)   # (S, 32)
    blk = torch.arange(SB_BLOCKS, device=dev)[None, :, None]
    out = torch.zeros((4, nt, RAY_TILE), dtype=torch.float32, device=dev)
    out[0] = torch.clamp_max(t_p, INF).reshape(nt, RAY_TILE)
    out[1] = -1.0
    use_list = cnt <= k
    n_iter = torch.where(use_list, cnt, n_sb)
    worst_hi = torch.full((nt,), INF_HI, dtype=torch.int32, device=dev)
    walking = torch.ones((nt,), dtype=torch.bool, device=dev)
    work = torch.zeros((nt, 3), dtype=torch.int32, device=dev)
    run = torch.zeros((nt,), dtype=torch.int64, device=dev)
    j = 0
    while True:
        v_ = cand[:, min(j, k - 1)]
        key_hi = torch.where(use_list, v_ >> 16, 0)
        walking = walking & (j < n_iter) & (key_hi <= worst_hi)
        tiles = torch.nonzero(walking).flatten()
        if tiles.numel() == 0:
            break
        sb = torch.where(use_list, v_ & 0xFFFF, j)[tiles].long()
        box = bl.blk_box[sb]                                     # (A, 32, 8)
        r = ray[:, tiles]                                        # (6, A, 256)
        iv = inv[:, tiles]
        lo_t, hi_t = [], []
        for a in range(3):
            t0 = (box[:, :, a][:, :, None] - r[a][:, None, :]) * iv[a][:, None, :]
            t1 = (box[:, :, a + 3][:, :, None] - r[a][:, None, :]) * iv[a][:, None, :]
            lo_t.append(torch.minimum(t0, t1))
            hi_t.append(torch.maximum(t0, t1))
        tnr = torch.maximum(torch.maximum(lo_t[0], lo_t[1]), torch.clamp_min(lo_t[2], 0.0))
        tfr = torch.minimum(torch.minimum(hi_t[0], hi_t[1]), hi_t[2])
        cur = out[0, tiles]                                      # best before the step
        gate = (tfr >= tnr) & (tnr <= cur[:, None, :])           # (A, 32, 256)
        bits = gate.reshape(-1, SB_BLOCKS, N_SUB, SUB_TILE).any(dim=3)  # (A, 32, 2)
        res = _step_visits(bl, ray, cur, tiles, sb, bits, any_hit)
        if any_hit:
            first = res
            got = first < SB_BLOCKS
            out[0, tiles] = torch.where(got, -1.0, cur)
            out[1, tiles] = torch.where(got, 1.0, out[1, tiles])
        else:
            first = torch.full_like(cur, SB_BLOCKS, dtype=torch.int64)
            take = res[0] < cur
            for row, val in enumerate(res):
                out[row, tiles] = torch.where(take, val, out[row, tiles])
        # needed tests: per ray the blocks its own gate passed, up to and
        # including its first hit (any-hit), times their real triangles
        own = gate & (cur > EPS_T)[:, None, :] & (blk <= first[:, None, :])
        work[tiles, 2] += (own.sum(dim=2, dtype=torch.int32) * real[sb]).sum(dim=1,
                                                                             dtype=torch.int32)
        work[tiles, 1] += bits.sum(dim=(1, 2), dtype=torch.int32)
        work[tiles, 0] += 1
        run[tiles] += (bits.sum(dim=2) * real[sb]).sum(dim=1) * SUB_TILE
        worst = out[0, tiles].contiguous().view(torch.int32).max(dim=1).values
        worst_hi[tiles] = worst >> 16
        j += 1
    return (out.reshape(4, npad), work, run) if tests_run else (out.reshape(4, npad), work)


def _kernel_fn(any_hit: bool):
    key = "any" if any_hit else "closest"
    f = _FN.get(key)
    if f is None:
        f = getattr(build.load("intersect_blocklist"), f"blocklist_{key}")
        # (cand, cnt, k, ray (6, npad), tmax, npad, blk_box, tri_pack, n_sb,
        #  out (4, npad), work (nt, 3), stream)
        f.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
        f.restype = ctypes.c_int
        _FN[key] = f
    return f


def launch_shape(npad: int, any_hit: bool = False) -> dict:
    """The kernel's launch geometry for npad padded rays on the current
    card: CTAs, threads per CTA, CTAs per cluster (one cluster per tile)
    and shared memory per CTA in bytes."""
    f = build.load("intersect_blocklist").blocklist_geometry
    f.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    f.restype = ctypes.c_int
    out = (ctypes.c_int * 4)()
    build.check(f(npad, int(any_hit), ctypes.cast(out, ctypes.c_void_p)), "intersect_blocklist")
    return dict(zip(("ctas", "threads", "cluster", "smem_bytes"), out))


def blocklist_cuda(bl: BlockList, o_p, d_p, t_p, cand, cnt, any_hit: bool = False):
    """Launch the CUDA kernel; the contract of ``blocklist_plain``."""
    if not any_hit:
        build.refuse_grad("intersect_blocklist", bl.tri_pack, o_p, d_p)
    tensors = (bl.tri_pack, bl.blk_box, o_p, d_p, t_p, cand, cnt)
    if not all(x.is_cuda for x in tensors):
        raise ValueError("intersect_blocklist: all tensors must be on the card")
    npad = o_p.shape[0]
    nt = npad // RAY_TILE
    n_sb = bl.tri_pack.shape[0]
    if npad % RAY_TILE or o_p.shape != (npad, 3) or d_p.shape != (npad, 3) \
            or t_p.shape != (npad,):
        raise ValueError("intersect_blocklist: rays must be padded to tiles of 256")
    if tuple(bl.tri_pack.shape[1:]) != (SB_BLOCKS, 16, BLOCK_TRIS) \
            or tuple(bl.blk_box.shape) != (n_sb, SB_BLOCKS, 8):
        raise ValueError("intersect_blocklist: bad block tables")
    if cand.dtype != torch.int32 or cnt.dtype != torch.int32 or cand.shape[0] != nt \
            or cnt.shape != (nt,):
        raise TypeError("intersect_blocklist: cand (nt, k) and cnt (nt,) must be int32")
    if cand.shape[1] > MAX_CAND:
        raise ValueError(f"intersect_blocklist: list width {cand.shape[1]} above {MAX_CAND}")
    if any(x.dtype != torch.float32 for x in (bl.tri_pack, bl.blk_box, o_p, d_p, t_p)):
        raise TypeError("intersect_blocklist: expected float32 rays and tables")
    # the kernel reads these while it runs: keep every buffer referenced
    ray = torch.cat([o_p.T, d_p.T], dim=0).contiguous()
    cand, cnt, t_p = cand.contiguous(), cnt.contiguous(), t_p.contiguous()
    blk_box, tri_pack = bl.blk_box.contiguous(), bl.tri_pack.contiguous()
    out = torch.empty((4, npad), dtype=torch.float32, device=o_p.device)
    work = torch.empty((nt, 3), dtype=torch.int32, device=o_p.device)
    args = (build.ptr(cand), build.ptr(cnt), cand.shape[1], build.ptr(ray), build.ptr(t_p),
            npad, build.ptr(blk_box), build.ptr(tri_pack), n_sb, build.ptr(out),
            build.ptr(work), build.stream_ptr(o_p.device))
    build.check(_kernel_fn(any_hit)(*args), "intersect_blocklist")
    build.LAUNCHES["intersect_blocklist"] += 1
    return out, work


def blocklist_run(bl: BlockList, o, d, tmax, k: int = MAX_CAND, any_hit: bool = False):
    """Pad, stage A and the kernel (CUDA) or its plain version (CPU).
    Returns (out (4, npad), work (nt, 3))."""
    if bl.sb_lo.shape[0] > 65535:
        raise ValueError("blocklist: more than 65535 superblocks (packed-key limit)")
    o_p, d_p, t_p, npad = _pad_rays(o, d, tmax)
    cand, cnt = candidate_superblocks(bl.sb_lo, bl.sb_hi, o_p, d_p, t_p,
                                      cand_width(npad, bl.sb_lo.shape[0], k))
    fn = blocklist_cuda if o.is_cuda else blocklist_plain
    return fn(bl, o_p, d_p, t_p, cand, cnt, any_hit)


def intersect_blocklist_raw(bl: BlockList, o, d, tmax, k: int = MAX_CAND):
    """Closest hit: (t, prim int32, u, v, valid), the Hit contract of
    accel/traverse.py."""
    n = o.shape[0]
    out = blocklist_run(bl, o, d, tmax, k)[0]
    t, prim_f = out[0, :n], out[1, :n]
    valid = (prim_f >= 0.0) & (t < INF)
    return (torch.where(valid, t, INF), torch.where(valid, prim_f, -1.0).to(torch.int32),
            out[2, :n], out[3, :n], valid)


def occluded_blocklist_raw(bl: BlockList, o, d, tmax, k: int = MAX_CAND):
    """Any-hit: True where some triangle lies within (EPS_T, tmax)."""
    return blocklist_run(bl, o, d, tmax, k, any_hit=True)[0][1, :o.shape[0]] > 0.0


def spread3(v):
    """Spread the low 10 bits of int32 v to every third bit."""
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _spread2(v):
    """Spread the low 16 bits of int32 v to every second bit."""
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def _ray_sort_keys(bl: BlockList, o, d):
    """int32 key: the Morton code of the origin's cell (SORT_POS_BITS per
    axis in the scene box), then the 2-D Morton code of the octahedral map
    of the direction (SORT_DIR_BITS per component).  Cells are coarse so
    that one holds several tiles of rays, whose directions the low bits
    then order."""
    lo = torch.min(bl.sb_lo, dim=0).values
    hi = torch.max(bl.sb_hi, dim=0).values
    q = torch.clamp((o - lo) / torch.clamp_min(hi - lo, 1e-9), 0.0, 1.0 - 1e-6)
    cell = (q * float(1 << SORT_POS_BITS)).to(torch.int32)
    m = (spread3(cell[:, 0]) << 2) | (spread3(cell[:, 1]) << 1) | spread3(cell[:, 2])
    ad = torch.abs(d)
    an = ad[:, 0] + ad[:, 1] + ad[:, 2]
    px = d[:, 0] / an
    py = d[:, 1] / an
    ox = torch.where(d[:, 2] < 0, (1 - torch.abs(py)) * torch.sign(px), px)
    oy = torch.where(d[:, 2] < 0, (1 - torch.abs(px)) * torch.sign(py), py)
    dres = 1 << SORT_DIR_BITS
    qu = torch.clamp(((ox + 1) * 0.5 * dres).to(torch.int32), 0, dres - 1)
    qv = torch.clamp(((oy + 1) * 0.5 * dres).to(torch.int32), 0, dres - 1)
    return (m << (2 * SORT_DIR_BITS)) | (_spread2(qu) << 1) | _spread2(qv)


def unsort(perm, *xs):
    """Scatter results computed in ``perm`` order back to ray order."""
    outs = []
    for x in xs:
        y = torch.empty_like(x)
        y[perm] = x
        outs.append(y)
    return tuple(outs)


def occluded_blocklist_sorted(bl: BlockList, o, d, tmax):
    """Any-hit on rays sorted by ``_ray_sort_keys`` (stable), scattered
    back to ray order."""
    perm = torch.argsort(_ray_sort_keys(bl, o, d), stable=True)
    return unsort(perm, occluded_blocklist_raw(bl, o[perm], d[perm], tmax[perm]))[0]


def intersect_blocklist_sorted(bl: BlockList, o, d, tmax):
    """Closest hit on rays sorted by ``_ray_sort_keys`` (stable),
    scattered back to ray order."""
    perm = torch.argsort(_ray_sort_keys(bl, o, d), stable=True)
    return unsort(perm, *intersect_blocklist_raw(bl, o[perm], d[perm], tmax[perm]))
