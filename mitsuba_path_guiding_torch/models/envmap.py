"""Lat-long environment map: build, evaluate, importance-sample (port of
the reference's models/envmap.py).

The 2-D luminance distribution is tabulated host-side in numpy, with the
reference's arithmetic, as a marginal row CDF and per-row conditional
CDFs; sampling inverts both with ``torch.searchsorted``.

Direction convention (y up, as ``scene/transforms.look_at``):
v = theta / pi with theta measured from +y, u = 0.5 + atan2(d.x, -d.z) / 2pi.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_path_guiding_torch.core.math import safe_sqrt
from mitsuba_path_guiding_torch.core.spectrum import LUM_WEIGHTS_NP


def build_env_tables(image: np.ndarray, scale: float = 1.0) -> dict:
    """(He, We, 3) image -> the numpy tables of the ``Emitters.env_*``
    fields.  ``env_pdf_tex[r, c]`` is the direction-independent part of
    the solid-angle pdf of a direction in texel (r, c), given that the
    environment was picked; ``env_pdf_dir`` divides by sin(theta)."""
    img = np.asarray(image, dtype=np.float32) * scale
    he, we = img.shape[0], img.shape[1]
    lum = img @ LUM_WEIGHTS_NP
    theta = (np.arange(he) + 0.5) / he * np.pi
    sin_t = np.sin(theta)
    w = lum * sin_t[:, None] + 1e-12           # row-area-weighted luminance
    row_w = w.sum(axis=1)
    cdf_rows = np.cumsum(row_w) / row_w.sum()
    cdf_cols = np.cumsum(w, axis=1) / w.sum(axis=1, keepdims=True)
    p_texel = w / w.sum()
    pdf_tex = p_texel * (he * we) / (2.0 * np.pi * np.pi)
    return {
        "env_image": np.asarray(img),
        "env_cdf_rows": cdf_rows.astype(np.float32),
        "env_cdf_cols": cdf_cols.astype(np.float32),
        "env_pdf_tex": pdf_tex.astype(np.float32),
    }


def constant_env_tables(radiance) -> dict:
    return build_env_tables(np.asarray(radiance, np.float32).reshape(1, 1, 3))


def dir_to_uv(d: torch.Tensor):
    """(N, 3) direction -> (u, v) in [0, 1)."""
    theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 0], -d[..., 2])
    u = phi / (2.0 * math.pi) + 0.5
    v = theta / math.pi
    return torch.remainder(u, 1.0), torch.clamp(v, 0.0, 1.0 - 1e-7)


def uv_to_dir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    theta = v * math.pi
    phi = (u - 0.5) * 2.0 * math.pi
    st = torch.sin(theta)
    return torch.stack([st * torch.sin(phi), torch.cos(theta), -st * torch.cos(phi)], dim=-1)


def _texel(shape, d):
    he, we = shape[0], shape[1]
    u, v = dir_to_uv(d)
    r = torch.clamp((v * he).to(torch.int64), 0, he - 1)
    c = torch.clamp((u * we).to(torch.int64), 0, we - 1)
    return r, c


def env_eval(em, d: torch.Tensor) -> torch.Tensor:
    """Radiance of escaped rays (nearest texel; a (1, 1) map is constant)."""
    r, c = _texel(em.env_image.shape, d)
    return em.env_image[r, c]


def env_pdf_dir(em, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle NEE pdf of direction d, given the environment was
    picked (the caller folds in the pick pmf)."""
    r, c = _texel(em.env_pdf_tex.shape, d)
    sin_t = torch.clamp_min(safe_sqrt(1.0 - d[..., 1] * d[..., 1]), 1e-5)
    return em.env_pdf_tex[r, c] / sin_t


def env_sample(em, u2: torch.Tensor):
    """Importance-sample a direction; returns (d, solid-angle pdf,
    radiance).  The row comes from the marginal CDF, the column from its
    row's conditional CDF (``torch.searchsorted`` on each lane's row); the
    CDF residuals give a continuous offset inside the texel."""
    he, we = em.env_pdf_tex.shape
    cdf_rows = em.env_cdf_rows
    r = torch.clamp(torch.searchsorted(cdf_rows, u2[..., 0].contiguous(), right=True), 0, he - 1)
    row_lo = torch.where(r > 0, cdf_rows[torch.clamp_min(r - 1, 0)], 0.0)
    row_hi = cdf_rows[r]
    fr = torch.clamp((u2[..., 0] - row_lo) / torch.clamp_min(row_hi - row_lo, 1e-12), 0.0, 1.0)

    rows = em.env_cdf_cols[r]  # (N, We)
    c = torch.searchsorted(rows, u2[..., 1:2].contiguous(), right=False)
    c = torch.clamp(c, 0, we - 1)  # (N, 1)
    col_lo = torch.where(c > 0, torch.gather(rows, 1, torch.clamp_min(c - 1, 0)), 0.0)[:, 0]
    col_hi = torch.gather(rows, 1, c)[:, 0]
    c = c[:, 0]
    fc = torch.clamp((u2[..., 1] - col_lo) / torch.clamp_min(col_hi - col_lo, 1e-12), 0.0, 1.0)

    uu = (c.to(torch.float32) + fc) / we
    vv = (r.to(torch.float32) + fr) / he
    d = uv_to_dir(uu, vv)
    sin_t = torch.clamp_min(torch.sin(vv * math.pi), 1e-5)
    return d, em.env_pdf_tex[r, c] / sin_t, em.env_image[r, c]
