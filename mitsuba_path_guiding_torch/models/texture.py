"""Bitmap and procedural textures (port of the reference's
models/texture.py): every texture of a scene lives in one padded atlas
(NT, 2*TH, TW, 3) with a box-filtered mip pyramid, and shading fetches it
per lane at the interpolated UV.

The build-time parts (``rasterize_procedural``, ``build_atlas``) are the
reference's numpy, so the atlas is equal to the reference's bit for bit.
The fetches index the atlas per lane with plain tensor indexing, as the
reference does outside any Pallas kernel: bilinear at the base level or
trilinear between two mip levels (``sample_atlas``), nearest at the base
level (``sample_atlas_nearest``, for data textures such as the cloth's
yarn records), and the elliptical weighted average over an 81-tap window
(``sample_atlas_ewa``).

Conventions are the reference's: UV wraps (repeat), v flips so that v = 0
is the image's bottom row, and mip level k of texture t sits at rows
[2*TH - (2*TH >> k), ... + (TH >> k)) and columns [0, TW >> k).
"""
from __future__ import annotations

import numpy as np
import torch

MAX_MIP_LEVELS = 8
MAX_ANISO = 8.0
EWA_TAPS = 4  # taps in [-EWA_TAPS, EWA_TAPS]^2 at the chosen level


def rasterize_procedural(spec: dict, res: int = 256) -> np.ndarray:
    """``checkerboard`` or ``gridtexture`` -> a (res, res, 3) image."""
    t = spec["type"]
    c0 = np.asarray(spec.get("color0", [0.4] * 3), np.float32)
    c1 = np.asarray(spec.get("color1", [0.2] * 3), np.float32)
    uu, vv = np.meshgrid(
        (np.arange(res) + 0.5) / res, (np.arange(res) + 0.5) / res, indexing="xy"
    )
    us = spec.get("uscale", 2.0)
    vs = spec.get("vscale", 2.0)
    if t == "checkerboard":
        mask = ((np.floor(uu * 2 * us) + np.floor(vv * 2 * vs)) % 2).astype(bool)
    elif t == "gridtexture":
        lw = float(spec.get("line_width", 0.01))
        fu = np.mod(uu * us, 1.0)
        fv = np.mod(vv * vs, 1.0)
        mask = (fu < lw) | (fu > 1 - lw) | (fv < lw) | (fv > 1 - lw)
    else:
        raise ValueError(f"unknown procedural texture {t}")
    img = np.where(mask[..., None], c1, c0)
    return img.astype(np.float32)


def _downsample(im: np.ndarray) -> np.ndarray:
    h, w = im.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    im = im[: h2 * 2, : w2 * 2]
    return 0.25 * (im[0::2, 0::2] + im[1::2, 0::2] + im[0::2, 1::2] + im[1::2, 1::2])


def build_atlas_np(images: list):
    """Pad the textures to a common size and bake each one's box-filtered
    mip pyramid: (atlas (NT, 2*TH, TW, 3), sizes (NT, 2)) as numpy.  No
    texture gives a (1, 2, 1, 3) atlas of zeros."""
    if not images:
        return np.zeros((1, 2, 1, 3), np.float32), np.ones((1, 2), np.float32)
    th = max(im.shape[0] for im in images)
    tw = max(im.shape[1] for im in images)
    atlas = np.zeros((len(images), 2 * th, tw, 3), dtype=np.float32)
    sizes = np.zeros((len(images), 2), dtype=np.float32)
    for i, im in enumerate(images):
        cur = np.asarray(im[..., :3], dtype=np.float32)
        sizes[i] = (im.shape[0], im.shape[1])
        for k in range(MAX_MIP_LEVELS):
            off = 2 * th - ((2 * th) >> k)
            atlas[i, off: off + cur.shape[0], : cur.shape[1]] = cur
            if cur.shape[0] <= 1 and cur.shape[1] <= 1:
                break
            cur = _downsample(cur)
    return atlas, sizes


def build_atlas(images: list, device=None):
    """``build_atlas_np`` as tensors on ``device``."""
    atlas, sizes = build_atlas_np(images)
    return torch.as_tensor(atlas, device=device), torch.as_tensor(sizes, device=device)


def _fetch(atlas, t, xs, ys, w, h, off):
    """Texels at integer-valued float coordinates (xs, ys) of a level whose
    size is (h, w) and row offset ``off``, wrapped."""
    xi = torch.remainder(xs, w).long()
    yi = (torch.remainder(ys, h) + off).long()
    return atlas[t, yi, xi]


def _level_geometry(atlas, sizes, t, lv):
    """(row offset, h, w) of mip level ``lv`` (a float tensor or 0.0) of
    each lane's texture."""
    th2 = atlas.shape[1]
    scale = torch.pow(2.0, lv) if torch.is_tensor(lv) else 2.0 ** lv
    off = th2 - torch.floor(th2 / scale) if torch.is_tensor(lv) else float(th2 - (th2 >> int(lv)))
    h = torch.clamp_min(torch.floor(sizes[t, 0] / scale), 1.0)
    w = torch.clamp_min(torch.floor(sizes[t, 1] / scale), 1.0)
    return off, h, w


def _bilinear(atlas, sizes, t, uv, lv):
    off, h, w = _level_geometry(atlas, sizes, t, lv)
    u = torch.remainder(uv[..., 0], 1.0) * w - 0.5
    v = torch.remainder(1.0 - uv[..., 1], 1.0) * h - 0.5
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    top = (_fetch(atlas, t, x0, y0, w, h, off) * (1 - fx)
           + _fetch(atlas, t, x0 + 1, y0, w, h, off) * fx)
    bot = (_fetch(atlas, t, x0, y0 + 1, w, h, off) * (1 - fx)
           + _fetch(atlas, t, x0 + 1, y0 + 1, w, h, off) * fx)
    return top * (1 - fy) + bot * fy


def sample_atlas_nearest(atlas, sizes, tid, uv):
    """The nearest texel of the base level, with ``sample_atlas``'s wrap
    and flip: for data textures whose channels must not blend across
    texels (the cloth's yarn-record map)."""
    t = torch.clamp_min(tid, 0).long()
    h = torch.clamp_min(sizes[t, 0], 1.0)
    w = torch.clamp_min(sizes[t, 1], 1.0)
    xi = torch.floor(torch.remainder(uv[..., 0], 1.0) * w)
    yi = torch.floor(torch.remainder(1.0 - uv[..., 1], 1.0) * h)
    xi = torch.minimum(torch.clamp_min(xi, 0.0), w - 1.0).long()
    yi = torch.minimum(torch.clamp_min(yi, 0.0), h - 1.0).long()
    return atlas[t, yi, xi]


def sample_atlas(atlas, sizes, tid, uv, lod=None):
    """Texture fetch: atlas (NT, 2*TH, TW, 3), tid (N,), uv (N, 2) ->
    (N, 3).  ``lod`` (N,) selects a fractional mip level (trilinear
    filtering; the ray-cone footprint comes from the integrator); None is
    bilinear at the base level."""
    t = torch.clamp_min(tid, 0).long()
    if lod is None:
        return _bilinear(atlas, sizes, t, uv, 0)
    max_l = MAX_MIP_LEVELS - 1
    lod = torch.clamp(lod, 0.0, float(max_l))
    l0 = torch.floor(lod)
    f = (lod - l0)[..., None]
    return (_bilinear(atlas, sizes, t, uv, l0) * (1 - f)
            + _bilinear(atlas, sizes, t, uv, torch.clamp_max(l0 + 1, float(max_l))) * f)


def sample_atlas_ewa(atlas, sizes, tid, uv, duv0, duv1):
    """Elliptical weighted average (anisotropic) lookup: ``duv0`` and
    ``duv1`` (N, 2) are the screen footprint's axes in UV space.  The
    minor axis picks the mip level (raised until the major half-axis fits
    the tap window); the level's texels inside the ellipse add with
    Gaussian weights over a static (2*EWA_TAPS+1)^2 window; the
    anisotropy is clamped to MAX_ANISO by widening the minor axis.  A
    footprint that catches no texel falls back to the base level's
    bilinear fetch."""
    t = torch.clamp_min(tid, 0).long()
    l0sq = torch.sum(duv0 * duv0, dim=-1)
    l1sq = torch.sum(duv1 * duv1, dim=-1)
    swap = (l1sq > l0sq)[..., None]
    major = torch.where(swap, duv1, duv0)
    minor = torch.where(swap, duv0, duv1)
    maj_len = torch.sqrt(torch.maximum(l0sq, l1sq))
    min_len = torch.sqrt(torch.minimum(l0sq, l1sq))
    scale_min = torch.where(min_len * MAX_ANISO < maj_len,
                            maj_len / (MAX_ANISO * torch.clamp_min(min_len, 1e-12)), 1.0)
    minor = minor * scale_min[..., None]
    min_len = min_len * scale_min

    res = torch.maximum(sizes[t, 0], sizes[t, 1])
    max_l = MAX_MIP_LEVELS - 1
    need = torch.maximum(min_len * res, maj_len * res / float(EWA_TAPS))
    lod = torch.clamp(torch.log2(torch.clamp_min(need, 1.0)), 0.0, float(max_l))
    off, h, w = _level_geometry(atlas, sizes, t, torch.floor(lod))
    # the ellipse in the level's texel coordinates
    u_c = torch.remainder(uv[..., 0], 1.0) * w - 0.5
    v_c = torch.remainder(1.0 - uv[..., 1], 1.0) * h - 0.5
    dux, duy = major[..., 0] * w, -major[..., 1] * h
    dvx, dvy = minor[..., 0] * w, -minor[..., 1] * h
    # implicit ellipse A x^2 + B xy + C y^2 = F
    A = duy * duy + dvy * dvy + 1.0
    B = -2.0 * (dux * duy + dvx * dvy)
    C = dux * dux + dvx * dvx + 1.0
    invF = 1.0 / torch.clamp_min(A * C - B * B * 0.25, 1e-12)
    A, B, C = A * invF, B * invF, C * invF

    acc = torch.zeros(uv.shape[:-1] + (3,), dtype=atlas.dtype, device=atlas.device)
    wsum = torch.zeros(uv.shape[:-1], dtype=atlas.dtype, device=atlas.device)
    x0 = torch.floor(u_c)
    y0 = torch.floor(v_c)
    for dy in range(-EWA_TAPS, EWA_TAPS + 1):
        for dx in range(-EWA_TAPS, EWA_TAPS + 1):
            xs = x0 + dx
            ys = y0 + dy
            ex = xs - u_c
            ey = ys - v_c
            r2 = A * ex * ex + B * ex * ey + C * ey * ey
            wgt = torch.where(r2 < 1.0, torch.exp(-2.0 * r2) - float(np.exp(np.float32(-2.0))),
                              0.0)
            acc = acc + _fetch(atlas, t, xs, ys, w, h, off) * wgt[..., None]
            wsum = wsum + wgt
    fallback = _bilinear(atlas, sizes, t, uv, 0)
    ok = (wsum > 1e-8)[..., None]
    return torch.where(ok, acc / torch.clamp_min(wsum, 1e-8)[..., None], fallback)
