"""Out-of-core tiled film: render and write large images in row bands.

The counterpart of Mitsuba's tiledhdrfilm plugin (films/tiledhdrfilm.cpp,
tile-at-a-time EXR output, so the full frame never lives in memory); a
port of the JAX package's film/tiled.py.  The film streams in row bands
(a band is one wave's pixel batch), each developed and appended to an
uncompressed scanline EXR whose offset table is computed up front: the
host holds one band, the device one wave.
"""
from __future__ import annotations

import struct

import numpy as np
import torch


def _exr_header(w: int, h: int):
    def attr(name, type_, data):
        return (
            name.encode() + b"\x00" + type_.encode() + b"\x00"
            + struct.pack("<I", len(data)) + data
        )

    ch = b""
    for cname in (b"B", b"G", b"R"):
        ch += cname + b"\x00" + struct.pack("<IiII", 2, 0, 1, 1)
    ch += b"\x00"
    header = b""
    header += attr("channels", "chlist", ch)
    header += attr("compression", "compression", b"\x00")
    header += attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1))
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"
    return header


class TiledEXRWriter:
    """Incremental scanline EXR writer: open, feed row bands top-down,
    close.  The offset table is precomputed (fixed uncompressed scanline
    size), so bands append sequentially."""

    def __init__(self, path: str, width: int, height: int):
        self.w, self.h = width, height
        magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
        header = _exr_header(width, height)
        first = len(magic) + len(header) + 8 * height
        self.scan_size = 8 + width * 4 * 3
        offsets = b"".join(
            struct.pack("<Q", first + i * self.scan_size) for i in range(height)
        )
        self.f = open(path, "wb")
        self.f.write(magic + header + offsets)
        self.next_row = 0

    def write_band(self, band: np.ndarray):
        """band: (rows, W, 3) float32, appended below previous bands."""
        band = np.asarray(band, dtype=np.float32)
        assert band.shape[1] == self.w and band.shape[2] == 3
        for r in range(band.shape[0]):
            row = band[r]
            data = row[:, 2].tobytes() + row[:, 1].tobytes() + row[:, 0].tobytes()
            self.f.write(struct.pack("<iI", self.next_row, len(data)) + data)
            self.next_row += 1

    def close(self):
        assert self.next_row == self.h, (
            f"tiled film incomplete: {self.next_row}/{self.h} rows"
        )
        self.f.close()


def render_tiled(scene, cfg, path: str, band_rows: int = 64, render_band=None) -> None:
    """Render to ``path`` one row band at a time (tiledhdrfilm's streaming
    develop), each band's waves by ``render_wave``, or by the caller's
    ``render_band(scene, cfg, pix, sidx) -> (film_xy (n, 2), L (n, 3))``."""
    from mitsuba_path_guiding_torch.film.film import splat
    from mitsuba_path_guiding_torch.integrators.render import render_wave

    w, h = cfg.width, cfg.height
    dev = scene.geo.p0.device
    writer = TiledEXRWriter(path, w, h)
    for y0 in range(0, h, band_rows):
        rows = min(band_rows, h - y0)
        pix = torch.arange(y0 * w, (y0 + rows) * w, dtype=torch.int64, device=dev)
        rgbw = torch.zeros((rows * w, 4), dtype=torch.float32, device=dev)
        for s in range(max(cfg.spp, 1)):
            sidx = torch.full_like(pix, s)
            if render_band is None:
                film_xy, L, _ = render_wave(scene, cfg, pix, sidx)
            else:
                film_xy, L = render_band(scene, cfg, pix, sidx)
            # band-local splat (box): film_xy rows shift by y0
            xy = film_xy - torch.tensor([0.0, float(y0)], device=dev)
            rgbw = splat(rgbw, xy, L, w, rows, "box")
        band = (rgbw[:, :3] / torch.clamp_min(rgbw[:, 3:4], 1e-9)).reshape(rows, w, 3)
        writer.write_band(band.cpu().numpy())
    writer.close()
