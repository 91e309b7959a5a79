"""Dense ray-triangle intersection for small scenes.

Port of ``mitsuba_path_guiding_tpu/ops/intersect_pallas.py``
``intersect_tiled``.  On a CUDA tensor the wrapper launches
``csrc/intersect_tiled.cu`` (four lanes a ray, each with a quarter of the
triangles, staged 128 at a time in shared memory; see the note there),
closest-hit or any-hit.  On a CPU tensor it takes the plain version,
``tiled_plain``: the (T, N) Moeller-Trumbore of ``accel/traverse.py``
``intersect_brute`` / ``occluded_brute``, the same arithmetic in the same
order, with the Pallas kernel's contract on a miss (u = v = 0).
"""
from __future__ import annotations

import ctypes

import torch

from mitsuba_path_guiding_torch.ops import build

TRI_TILE = 128
INF = 3.0e38
EPS_T = 1e-4
PLAIN_PAIRS = 1 << 22  # (triangle, ray) tests per step of tiled_plain (bounds memory)

_FN: dict = {}


def pack_triangles(p0: torch.Tensor, e1: torch.Tensor, e2: torch.Tensor) -> torch.Tensor:
    """(12, Tpad) layout [p0 e1 e2 id 0 0], Tpad a multiple of 128, pad
    triangles carrying id -1 (traverse.py _tri_pack_rows)."""
    t = p0.shape[0]
    tpad = ((t + TRI_TILE - 1) // TRI_TILE) * TRI_TILE
    pack = torch.zeros((12, tpad), dtype=torch.float32, device=p0.device)
    pack[0:3, :t] = p0.T
    pack[3:6, :t] = e1.T
    pack[6:9, :t] = e2.T
    pack[9, :t] = torch.arange(t, dtype=torch.float32, device=p0.device)
    pack[9, t:] = -1.0
    return pack


def mt_components(p0, e1, e2, o, d):
    """Moeller-Trumbore of every (triangle, ray) pair: (t, u, v, hit),
    each (T, N), in the order of intersect_pallas.py:53-74."""
    ox, oy, oz = o[:, 0][None, :], o[:, 1][None, :], o[:, 2][None, :]
    dx, dy, dz = d[:, 0][None, :], d[:, 1][None, :], d[:, 2][None, :]
    p0x, p0y, p0z = (p0[:, k][:, None] for k in range(3))
    e1x, e1y, e1z = (e1[:, k][:, None] for k in range(3))
    e2x, e2y, e2z = (e2[:, k][:, None] for k in range(3))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(torch.abs(det) < 1e-12, 0.0,
                          1.0 / torch.where(det == 0, 1.0, det))
    tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = (inv_det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > EPS_T)
    return t, u, v, hit


def closest_plain(p0, e1, e2, o, d, tmax):
    """Closest hit over all triangles; ties go to the lowest id.
    Returns (t, prim int32, u, v, valid)."""
    t, u, v, hit = mt_components(p0, e1, e2, o, d)
    hit = hit & (t < tmax[None, :])
    t = torch.where(hit, t, INF)
    bt = torch.min(t, dim=0).values
    valid = bt < INF
    tcount = t.shape[0]
    iota = torch.arange(tcount, dtype=torch.int32, device=t.device)[:, None]
    is_best = t == bt[None, :]
    prim = torch.min(torch.where(is_best, iota, tcount), dim=0).values
    first = is_best & (iota == prim[None, :])
    bu = torch.sum(torch.where(first, u, 0.0), dim=0)
    bv = torch.sum(torch.where(first, v, 0.0), dim=0)
    prim = torch.where(valid, prim, -1).to(torch.int32)
    return bt, prim, bu, bv, valid


def any_plain(p0, e1, e2, o, d, tmax):
    """Any hit before tmax (shadow rays)."""
    t, _, _, hit = mt_components(p0, e1, e2, o, d)
    return torch.any(hit & (t < tmax[None, :]), dim=0)


def tiled_plain(pack, o, d, tmax, n_tri: int, any_hit: bool = False):
    """Plain version of the tiled kernel, over the first ``n_tri``
    triangles of ``pack``, in steps of PLAIN_PAIRS tests.  A hit lies below
    min(tmax, INF), the Pallas kernel's running best before its first
    tile.  Closest hit: (t, prim, u, v, valid), ties to the lowest id, u
    and v read from the winning triangle (not summed, so a -0.0 keeps its
    sign) and 0 on a miss, as the Pallas and the CUDA kernel return them
    (``closest_plain``, the twin of JAX's ``intersect_brute``, returns
    triangle 0's there).  With ``any_hit``: the (N,) occlusion mask."""
    p0 = pack[0:3, :n_tri].T
    e1 = pack[3:6, :n_tri].T
    e2 = pack[6:9, :n_tri].T
    n = o.shape[0]
    step = max(1, PLAIN_PAIRS // n_tri)
    iota = torch.arange(n_tri, dtype=torch.int32, device=o.device)[:, None]
    parts = []
    for a in range(0, max(n, 1), step):
        t, u, v, hit = mt_components(p0, e1, e2, o[a:a + step], d[a:a + step])
        hit = hit & (t < torch.clamp_max(tmax[a:a + step], INF)[None, :])
        if any_hit:
            parts.append(torch.any(hit, dim=0))
            continue
        t = torch.where(hit, t, INF)
        bt = torch.min(t, dim=0).values
        valid = bt < INF
        prim = torch.min(torch.where(t == bt[None, :], iota, n_tri), dim=0).values
        win = prim.clamp_max(n_tri - 1).long()[None, :]
        bu = torch.where(valid, torch.gather(u, 0, win)[0], 0.0)
        bv = torch.where(valid, torch.gather(v, 0, win)[0], 0.0)
        parts.append((bt, torch.where(valid, prim, -1).to(torch.int32), bu, bv, valid))
    if any_hit:
        return torch.cat(parts)
    return tuple(torch.cat(x) for x in zip(*parts))


def _kernel_fn(any_hit: bool):
    key = "any" if any_hit else "closest"
    f = _FN.get(key)
    if f is None:
        f = getattr(build.load("intersect_tiled"), f"intersect_tiled_{key}")
        n_out = 1 if any_hit else 4
        f.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                      + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                      + [ctypes.c_void_p] * (n_out + 1))
        f.restype = ctypes.c_int
        _FN[key] = f
    return f


def _f32(x):
    if x.dtype != torch.float32:
        raise TypeError(f"intersect_tiled: expected float32, got {x.dtype}")
    return x.contiguous()


def intersect_tiled_cuda(pack, o, d, tmax, n_tri: int, any_hit: bool = False):
    """Launch the CUDA kernel.  Returns (t, prim, u, v, valid), or the
    (N,) bool occlusion mask when ``any_hit``."""
    if not (pack.is_cuda and o.is_cuda and d.is_cuda and tmax.is_cuda):
        raise ValueError("intersect_tiled: all tensors must be on the card")
    if pack.dim() != 2 or pack.shape[0] != 12 or pack.shape[1] % TRI_TILE:
        raise ValueError(f"intersect_tiled: bad triangle pack {tuple(pack.shape)}")
    pack, o, d, tmax = _f32(pack), _f32(o), _f32(d), _f32(tmax)
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or tmax.shape != (n,):
        raise ValueError("intersect_tiled: o, d must be (N, 3) and tmax (N,)")
    dev = o.device
    stream = build.stream_ptr(dev)
    args = (build.ptr(pack), pack.shape[1], int(n_tri), build.ptr(o), build.ptr(d),
            build.ptr(tmax), n)
    if any_hit:
        hit = torch.empty((n,), dtype=torch.bool, device=dev)
        build.check(_kernel_fn(True)(*args, build.ptr(hit), stream), "intersect_tiled any-hit")
        build.LAUNCHES["intersect_tiled"] += 1
        return hit
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    build.check(_kernel_fn(False)(*args, build.ptr(t), build.ptr(prim), build.ptr(u),
                                  build.ptr(v), stream), "intersect_tiled")
    build.LAUNCHES["intersect_tiled"] += 1
    return t, prim, u, v, prim >= 0


def intersect_tiled(pack, o, d, tmax, n_tri: int, any_hit: bool = False):
    """Closest hit (t, prim, u, v, valid) or, with ``any_hit``, the (N,)
    occlusion mask, of rays (o, d) below ``tmax`` against the first
    ``n_tri`` triangles of ``pack``."""
    if pack.is_cuda:
        return intersect_tiled_cuda(pack, o, d, tmax, n_tri, any_hit)
    return tiled_plain(pack, o, d, tmax, n_tri, any_hit)
