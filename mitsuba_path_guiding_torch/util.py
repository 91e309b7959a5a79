"""Image reading for the scene compiler (the reference's util.py
``_read``): bitmap textures and envmaps given by ``filename`` load
through here, in exactly the reference's formats.  The reference's
``mtsutil`` command line is not ported yet."""
from __future__ import annotations

import numpy as np


def _read(path: str) -> np.ndarray:
    low = path.lower()
    if low.endswith(".npy"):
        return np.load(path)
    if low.endswith(".pfm"):
        from mitsuba_path_guiding_torch.film.film import read_pfm

        return read_pfm(path)
    if low.endswith(".exr"):
        return _read_exr(path)
    raise ValueError(f"cannot read {path} (supported: npy, pfm, exr)")


def _read_exr(path: str) -> np.ndarray:
    """Scanline EXR (NONE/RLE/ZIP/PIZ/PXR24, half/float, multichannel),
    see film/exr.py."""
    from mitsuba_path_guiding_torch.film.exr import read_exr_rgb

    return read_exr_rgb(path)
