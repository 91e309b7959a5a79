"""Bitmap formats: load and save across the HDR and LDR formats, and
filtered resampling (a numpy copy of the reference's film/bitmap.py).

- The HDR codecs are pure Python: OpenEXR through ``film/exr.py``,
  Radiance RGBE (.hdr, with flat, old-RLE and new-RLE scanlines) and PFM.
- The LDR formats (PNG, JPEG, TGA, BMP) go through Pillow, imported only
  when an LDR file is read or written; without Pillow those calls raise
  ``ImportError``.
- Images are float32 numpy arrays (H, W, C) in linear space; LDR files
  are sRGB-decoded on load and encoded on save.
- Resampling is separable: one row-stochastic filtered weight matrix per
  axis, with the edges clamped.
"""
from __future__ import annotations

import os
import struct

import numpy as np

# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr) — bitmap.cpp readRGBE/writeRGBE (RLE scanlines)
# ---------------------------------------------------------------------------


def _float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float -> (..., 4) uint8 shared-exponent encoding."""
    maxc = rgb.max(axis=-1)
    rgbe = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    valid = maxc >= 1e-32
    # frexp: maxc = m * 2^e with m in [0.5, 1)
    m, e = np.frexp(np.where(valid, maxc, 1.0))
    scale = np.where(valid, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    mant = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., :3] = np.where(valid[..., None], mant, 0)
    rgbe[..., 3] = np.where(valid, (e + 128).astype(np.uint8), 0)
    return rgbe


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - (128 + 8)), 0.0)
    return rgbe[..., :3].astype(np.float32) * scale[..., None].astype(
        np.float32
    )


def write_hdr(path: str, img: np.ndarray) -> None:
    """Radiance RGBE with adaptive-RLE scanlines (bitmap.cpp writeRGBE)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    rgbe = _float_to_rgbe(img)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n# written by mitsuba_path_guiding_torch\n"
                b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if w < 8 or w > 32767:
            f.write(rgbe.tobytes())
            return
        for y in range(h):
            # new-style RLE: header 2,2,len_hi,len_lo then 4 planes
            f.write(struct.pack(">BBH", 2, 2, w))
            for c in range(4):
                f.write(_rle_encode_plane(rgbe[y, :, c]))


def _rle_encode_plane(plane: np.ndarray) -> bytes:
    out = bytearray()
    n = len(plane)
    i = 0
    while i < n:
        # find a run of >= 4 identical bytes
        run_start = i
        while run_start < n:
            run_len = 1
            while (run_start + run_len < n and run_len < 127
                   and plane[run_start + run_len] == plane[run_start]):
                run_len += 1
            if run_len >= 4:
                break
            run_start += 1
        # literal chunk before the run
        lit = run_start - i
        while lit > 0:
            chunk = min(lit, 128)
            out.append(chunk)
            out.extend(plane[i : i + chunk].tobytes())
            i += chunk
            lit -= chunk
        if run_start < n:
            run_len = 1
            while (run_start + run_len < n and run_len < 127
                   and plane[run_start + run_len] == plane[run_start]):
                run_len += 1
            out.append(128 + run_len)
            out.append(int(plane[run_start]))
            i = run_start + run_len
    return bytes(out)


def read_hdr(path: str) -> np.ndarray:
    """Radiance RGBE reader: flat + old-RLE + new-RLE scanlines."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    # header ends at blank line; next line is the resolution string
    pos = data.find(b"\n\n")
    if pos < 0:
        raise ValueError(f"{path}: malformed HDR header")
    end = data.find(b"\n", pos + 2)
    res = data[pos + 2 : end].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation {res}")
    h, w = int(res[1]), int(res[3])
    buf = data[end + 1 :]
    rgbe = np.zeros((h, w, 4), np.uint8)
    off = 0
    for y in range(h):
        if (w < 8 or w > 32767 or off + 4 > len(buf)
                or buf[off] != 2 or buf[off + 1] != 2):
            # flat or OLD-style RLE scanline.  Old RLE marks a run with an
            # (1,1,1,n) pixel meaning "repeat the previous pixel n<<shift
            # times" (consecutive markers raise shift by 8).  Fast path:
            # decode flat and fall back to the byte walk only when marker
            # pixels are present (a flat decode would corrupt genuine
            # old-RLE files).
            flat = np.frombuffer(
                buf, np.uint8, min(w * 4, len(buf) - off), off
            )
            if flat.size == w * 4:
                row = flat.reshape(w, 4)
                has_marker = bool(
                    ((row[:, 0] == 1) & (row[:, 1] == 1) & (row[:, 2] == 1)).any()
                )
                if not has_marker:
                    rgbe[y] = row
                    off += w * 4
                    continue
            row = np.zeros((w, 4), np.uint8)
            x = 0
            shift = 0
            while x < w:
                if off + 4 > len(buf):
                    raise ValueError(f"{path}: truncated old-RLE scanline")
                r_, g_, b_, e_ = buf[off], buf[off + 1], buf[off + 2], buf[off + 3]
                off += 4
                if r_ == 1 and g_ == 1 and b_ == 1:
                    if x == 0 and y == 0:
                        raise ValueError(f"{path}: old-RLE run before any pixel")
                    cnt = e_ << shift
                    prev = row[x - 1] if x > 0 else rgbe[y - 1, w - 1]
                    row[x : x + cnt] = prev
                    x += cnt
                    shift += 8
                else:
                    row[x] = (r_, g_, b_, e_)
                    x += 1
                    shift = 0
            rgbe[y] = row
            continue
        assert struct.unpack(">H", buf[off + 2 : off + 4])[0] == w
        off += 4
        for c in range(4):
            x = 0
            while x < w:
                code = buf[off]
                off += 1
                if code > 128:  # run
                    rgbe[y, x : x + code - 128, c] = buf[off]
                    off += 1
                    x += code - 128
                else:  # literal
                    rgbe[y, x : x + code, c] = np.frombuffer(
                        buf, np.uint8, code, off
                    )
                    off += code
                    x += code
    return _rgbe_to_float(rgbe)


# ---------------------------------------------------------------------------
# LDR codecs (PNG/JPEG/TGA/BMP) — PIL-backed, mirroring the reference's
# libpng/libjpeg linkage (bitmap.cpp readPNG/readJPEG/readTGA/readBMP)
# ---------------------------------------------------------------------------


def _pillow():
    """Pillow's Image module; the LDR codecs need it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading or writing PNG, JPEG, TGA or BMP needs Pillow, "
                          "which is not installed") from e
    return Image


def _srgb_to_linear(x: np.ndarray) -> np.ndarray:
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _linear_to_srgb_u8(img: np.ndarray) -> np.ndarray:
    from mitsuba_path_guiding_torch.core.spectrum import srgb_encode_np

    return (np.clip(srgb_encode_np(np.clip(img, 0, 1)), 0, 1) * 255
            + 0.5).astype(np.uint8)


def read_ldr(path: str, gamma_decode: bool = True) -> np.ndarray:
    """8/16-bit LDR formats -> linear float32 (H, W, C)."""
    Image = _pillow()

    im = Image.open(path)
    if im.mode in ("P", "LA", "RGBA", "CMYK"):
        im = im.convert("RGB")
    arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[..., None]
    scale = 65535.0 if arr.dtype == np.uint16 else 255.0
    x = arr.astype(np.float32) / scale
    return _srgb_to_linear(x) if gamma_decode else x


def write_ldr(path: str, img: np.ndarray, gamma_encode: bool = True,
              quality: int = 95) -> None:
    """Linear float32 -> 8-bit LDR file; format from the extension."""
    Image = _pillow()

    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    u8 = (_linear_to_srgb_u8(img) if gamma_encode
          else (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))
    im = Image.fromarray(u8)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".jpg", ".jpeg"):
        # 4:4:4 — chroma subsampling is a large-error default on synthetic
        # content (bitmap.cpp writeJPEG also writes full-resolution chroma)
        im.save(path, quality=quality, subsampling=0)
    else:
        im.save(path)


# ---------------------------------------------------------------------------
# unified load/save (bitmap.cpp Bitmap::Bitmap(path) format sniffing +
# Bitmap::write dispatch)
# ---------------------------------------------------------------------------

HDR_EXTS = (".exr", ".pfm", ".hdr", ".rgbe", ".npy")
LDR_EXTS = (".png", ".jpg", ".jpeg", ".tga", ".bmp")


def load(path: str) -> np.ndarray:
    """Read any supported image as linear float32 (H, W, C)."""
    low = path.lower()
    if low.endswith(".exr"):
        from mitsuba_path_guiding_torch.film.exr import read_exr_rgb

        return np.asarray(read_exr_rgb(path), np.float32)
    if low.endswith(".pfm"):
        from mitsuba_path_guiding_torch.film.film import read_pfm

        return np.asarray(read_pfm(path), np.float32)
    if low.endswith((".hdr", ".rgbe")):
        return read_hdr(path)
    if low.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if low.endswith(LDR_EXTS):
        return read_ldr(path)
    raise ValueError(f"unsupported image format: {path}")


def save(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write linear float32 (H, W, C) to any supported format."""
    low = path.lower()
    img = np.asarray(img, np.float32)
    if low.endswith((".exr", ".pfm", ".npy")):
        from mitsuba_path_guiding_torch.film.film import write_image

        write_image(path, img)
    elif low.endswith((".hdr", ".rgbe")):
        write_hdr(path, img)
    elif low.endswith(LDR_EXTS):
        write_ldr(path, img, quality=quality)
    else:
        raise ValueError(f"unsupported image format: {path}")


# ---------------------------------------------------------------------------
# separable filtered resampling (rescale.h Resampler; bitmap.cpp resample)
# ---------------------------------------------------------------------------


def _filter_eval(name: str, x: np.ndarray, radius: float) -> np.ndarray:
    ax = np.abs(x)
    if name == "box":
        return (ax <= 0.5).astype(np.float64)
    if name == "tent":
        return np.maximum(0.0, 1.0 - ax / radius)
    if name == "gaussian":
        s = radius / 2.0
        return np.where(ax <= radius,
                        np.exp(-0.5 * (x / s) ** 2)
                        - np.exp(-0.5 * (radius / s) ** 2), 0.0)
    if name == "lanczos":
        a = radius

        def sinc(t):
            t = np.where(np.abs(t) < 1e-8, 1e-8, t)
            return np.sin(np.pi * t) / (np.pi * t)

        return np.where(ax < a, sinc(x) * sinc(x / a), 0.0)
    raise ValueError(f"unknown resampling filter: {name}")


_DEFAULT_RADIUS = {"box": 0.5, "tent": 1.0, "gaussian": 2.0, "lanczos": 3.0}


def _resample_matrix(n_src: int, n_dst: int, name: str) -> np.ndarray:
    """(n_dst, n_src) row-stochastic filtered-sampling matrix with edge
    clamping (rescale.h's per-output-pixel weight normalization)."""
    radius = _DEFAULT_RADIUS[name]
    scale = n_src / n_dst
    support = radius * max(scale, 1.0)  # widen when minifying
    centers = (np.arange(n_dst) + 0.5) * scale  # in source coords
    lo = np.floor(centers - support).astype(int)
    width = int(np.ceil(2 * support)) + 2
    taps = lo[:, None] + np.arange(width)[None, :]
    x = (taps + 0.5 - centers[:, None]) / max(scale, 1.0)
    wts = _filter_eval(name, x, radius)
    taps_c = np.clip(taps, 0, n_src - 1)
    mat = np.zeros((n_dst, n_src))
    np.add.at(mat, (np.repeat(np.arange(n_dst), width), taps_c.ravel()),
              wts.ravel())
    rowsum = mat.sum(axis=1, keepdims=True)
    return (mat / np.maximum(rowsum, 1e-12)).astype(np.float32)


def resample(img: np.ndarray, width: int, height: int,
             rfilter: str = "lanczos", clamp: bool = True) -> np.ndarray:
    """Filtered resize to (height, width).  Separable: column matrix @
    image @ row-matrix^T, two dense matmuls on the host."""
    img = np.asarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    if (w, h) != (width, height):
        my = _resample_matrix(h, height, rfilter)
        mx = _resample_matrix(w, width, rfilter)
        img = np.einsum("yh,hwc,xw->yxc", my, img, mx, optimize=True)
    if clamp:
        img = np.maximum(img, 0.0)  # kill lanczos ringing undershoot
    return img[..., 0] if squeeze else img
