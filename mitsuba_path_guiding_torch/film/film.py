"""Film: weighted sample accumulation with reconstruction-filter
splatting (port of the reference's film/film.py).

One (H*W, 4) accumulator (filtered RGB sum + filter weight) updated by
scatter-add over pixel ids (``core.math.scatter_add_rows``, in an order
fixed by the data, so a render repeats bit for bit on the card too): the
box filter adds each sample to its own pixel, the other filters to the
(2R) x (2R) pixels of its footprint.  The accumulator is updated in place: the caller owns it,
and every splat returns it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mitsuba_path_guiding_torch.core.math import scatter_add_rows
from mitsuba_path_guiding_torch.core.spectrum import srgb_encode_np
from mitsuba_path_guiding_torch.film.rfilter import get_filter


class Film(NamedTuple):
    rgb_weight: torch.Tensor  # (H*W, 4)
    width: int
    height: int


def new_film(width: int, height: int, device=None) -> Film:
    return Film(
        rgb_weight=torch.zeros((width * height, 4), dtype=torch.float32, device=device),
        width=width,
        height=height,
    )


def splat(rgb_weight, film_xy, values, width: int, height: int,
          filter_name: str = "box", sample_weight=None):
    """Scatter samples (film_xy (N, 2), values (N, 3)) into the
    accumulator through a reconstruction filter: each pixel of the
    footprint takes the filter's weight at its centre.  The box filter's
    only tap is the containing pixel.  Updates ``rgb_weight`` in place."""
    fn, radius = get_filter(filter_name)
    n = film_xy.shape[0]
    if sample_weight is None:
        sample_weight = torch.ones((n,), dtype=torch.float32, device=values.device)
    if filter_name == "box":
        px = torch.clamp(torch.floor(film_xy[..., 0]).to(torch.int64), 0, width - 1)
        py = torch.clamp(torch.floor(film_xy[..., 1]).to(torch.int64), 0, height - 1)
        pid = py * width + px
        upd = torch.cat([values * sample_weight[..., None], sample_weight[..., None]], dim=-1)
        return scatter_add_rows(rgb_weight, pid, upd)
    cx = torch.floor(film_xy[..., 0] - 0.5).to(torch.int64)
    cy = torch.floor(film_xy[..., 1] - 0.5).to(torch.int64)
    idxs, updates = [], []
    for oy in range(-radius + 1, radius + 1):
        for ox in range(-radius + 1, radius + 1):
            px, py = cx + ox, cy + oy
            # the filter's weight at the pixel centre (px + 0.5, py + 0.5)
            w = (fn(px.to(torch.float32) + 0.5 - film_xy[..., 0])
                 * fn(py.to(torch.float32) + 0.5 - film_xy[..., 1]) * sample_weight)
            inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
            w = torch.where(inside, w, 0.0)
            idxs.append(torch.clamp(py, 0, height - 1) * width + torch.clamp(px, 0, width - 1))
            updates.append(torch.cat([values * w[..., None], w[..., None]], dim=-1))
    return scatter_add_rows(rgb_weight, torch.cat(idxs), torch.cat(updates))


def splat_box_aligned(rgb_weight, values, n_pix: int, sample_weight=None):
    """Box splat for pixel-aligned waves: ``values`` (S*n_pix, 3) is S
    complete spp-planes (sample i belongs to pixel i % n_pix), so the
    scatter-add is a reshape and a sum over planes.  In place."""
    s = values.shape[0] // n_pix
    if sample_weight is None:
        acc = torch.sum(values.reshape(s, n_pix, 3), dim=0)
        w = torch.full((n_pix, 1), float(s), dtype=rgb_weight.dtype, device=rgb_weight.device)
    else:
        acc = torch.sum((values * sample_weight[..., None]).reshape(s, n_pix, 3), dim=0)
        w = torch.sum(sample_weight.reshape(s, n_pix), dim=0)[..., None]
    return rgb_weight.add_(torch.cat([acc, w], dim=-1))


def develop(film: Film) -> torch.Tensor:
    """(H, W, 3) image = filtered RGB / filter weight."""
    rgbw = film.rgb_weight
    img = rgbw[..., 0:3] / torch.clamp_min(rgbw[..., 3:4], 1e-8)
    return img.reshape(film.height, film.width, 3)


def _host(img) -> np.ndarray:
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    return np.asarray(img, dtype=np.float32)


def write_npy(path: str, img) -> None:
    np.save(path, _host(img))


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        c = 3 if header == b"PF" else 1
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4")
    return data.reshape(h, w, c)[::-1]


def write_png(path: str, img, gamma_encode: bool = True) -> None:
    """8-bit RGB PNG (zlib from the standard library)."""
    import struct
    import zlib

    img = _host(img)
    if gamma_encode:
        img = srgb_encode_np(img)
    arr = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_pfm(path: str, img) -> None:
    img = _host(img)
    h, w, c = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(img[::-1].tobytes())


def write_exr_channels(path: str, channels: dict) -> None:
    """ZIP-compressed scanline OpenEXR of named FLOAT channels
    ({name: (H, W)})."""
    from mitsuba_path_guiding_torch.film.exr import write_exr as _write

    _write(path, {k: _host(v) for k, v in channels.items()}, compression="zip", half=False)


def write_exr(path: str, img) -> None:
    """ZIP-compressed scanline OpenEXR (FLOAT RGB)."""
    img = _host(img)
    write_exr_channels(path, {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]})


def write_image(path: str, img) -> None:
    """Dispatch on extension (npy/pfm/png/exr)."""
    low = path.lower()
    if low.endswith(".npy"):
        write_npy(path, img)
    elif low.endswith(".pfm"):
        write_pfm(path, img)
    elif low.endswith(".png"):
        write_png(path, img)
    elif low.endswith(".exr"):
        write_exr(path, img)
    else:
        raise ValueError(f"unknown image extension: {path}")


def splat_raw(acc, film_xy, values, width: int, height: int):
    """Weightless nearest-pixel scatter-add, for the light-image splats of
    the adjoint strategies; acc (H*W, 3), updated in place."""
    px = torch.clamp(torch.floor(film_xy[..., 0]).to(torch.int64), 0, width - 1)
    py = torch.clamp(torch.floor(film_xy[..., 1]).to(torch.int64), 0, height - 1)
    return scatter_add_rows(acc, py * width + px, values)
