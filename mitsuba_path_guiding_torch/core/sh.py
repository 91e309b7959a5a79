"""Real spherical harmonics: evaluation, projection, rotation, sampling.

Port of ``mitsuba_path_guiding_tpu/core/sh.py`` (Mitsuba's
SHVector, SHRotation and SHSampler).  Coefficients live in a flat
(bands^2,) tensor ordered (l, m), index l (l + 1) + m; the basis is the
associated-Legendre recurrence vectorised over directions, in the
reference's order of operations.  ``project`` and ``rotation_matrix`` set
up their quadrature grids on the host in numpy float64 and evaluate the
basis on ``device``; ``sample_sh`` draws from a 2-D inverse CDF over an
equal-area (cos theta, phi) grid whose cumulative sum adds in XLA's CPU
order (``core/rng.py`` ``cumsum_xla``), so its ``searchsorted`` edges are
the reference's.  Directions are unit (x, y, z), theta measured from +z.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.core.rng import cumsum_xla


def n_coeffs(bands: int) -> int:
    return bands * bands


def _index(l: int, m: int) -> int:
    return l * (l + 1) + m


def eval_basis(d: torch.Tensor, bands: int) -> torch.Tensor:
    """SH basis values for unit directions d (..., 3) -> (..., bands^2),
    real SH with the reference's normalisation."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [None] * (bands * bands)
    r_xy = torch.sqrt(torch.clamp_min(x * x + y * y, 1e-24))
    cphi = torch.where(r_xy > 1e-12, x / r_xy, 1.0)
    sphi = torch.where(r_xy > 1e-12, y / r_xy, 0.0)
    ct = z
    st = r_xy

    pmm = torch.ones_like(ct)
    cos_m = [torch.ones_like(ct)]  # cos(m phi), m = 0..bands-1
    sin_m = [torch.zeros_like(ct)]
    for m in range(1, bands):
        cos_m.append(cos_m[-1] * cphi - sin_m[-1] * sphi)
        sin_m.append(sin_m[-1] * cphi + cos_m[-2] * sphi)

    for m in range(bands):
        if m > 0:
            pmm = pmm * (-(2 * m - 1)) * st  # P_m^m
        p_prev, p_cur = torch.zeros_like(ct), pmm
        for l in range(m, bands):
            if l > m:
                p_next = ((2 * l - 1) * ct * p_cur - (l + m - 1) * p_prev) / (l - m)
                p_prev, p_cur = p_cur, p_next
            k = math.sqrt(
                (2 * l + 1) / (4 * math.pi)
                * math.factorial(l - m) / math.factorial(l + m)
            )
            if m == 0:
                out[_index(l, 0)] = k * p_cur
            else:
                s2 = math.sqrt(2.0) * k
                out[_index(l, m)] = s2 * cos_m[m] * p_cur
                out[_index(l, -m)] = s2 * sin_m[m] * p_cur
    return torch.stack(out, dim=-1)


def eval_sh(coeffs: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Evaluate an SH expansion at unit directions: (..., 3) -> (...,)."""
    bands = int(round(math.sqrt(coeffs.shape[-1])))
    return torch.sum(eval_basis(d, bands) * coeffs, dim=-1)


def _sphere_grid(res: int, width: int):
    """Directions of an equal-angle (theta, phi) grid of res x width
    cells, flattened, and the cells' theta."""
    th = (np.arange(res) + 0.5) / res * np.pi
    ph = (np.arange(width) + 0.5) / width * 2 * np.pi
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    d = np.stack(
        [np.sin(TH) * np.cos(PH), np.sin(TH) * np.sin(PH), np.cos(TH)], axis=-1
    ).reshape(-1, 3)
    return d, TH


def _f32(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def project(fn, bands: int, res: int = 64, device=None) -> torch.Tensor:
    """Project a function of direction (a float32 (N, 3) tensor -> (N,))
    onto SH: quadrature over an equal-angle grid, host-side sums in
    float64, returned as float32 on ``device``."""
    dev = resolve_device(device)
    d, TH = _sphere_grid(res, 2 * res)
    dA = (np.pi / res) * (2 * np.pi / (2 * res)) * np.sin(TH).reshape(-1)
    dd = _f32(d, dev)
    vals = _host(fn(dd))
    basis = _host(eval_basis(dd, bands))
    return _f32((basis * (vals * dA)[:, None]).sum(axis=0), dev)


def rotation_matrix(R, bands: int, res: int = 48, device=None) -> torch.Tensor:
    """(bands^2, bands^2) matrix M with eval_sh(M @ c, d) == eval_sh(c,
    R^T d), built on the host by projecting the rotated basis functions
    on a quadrature grid; exact for band-limited inputs."""
    dev = resolve_device(device)
    d, TH = _sphere_grid(res, 2 * res)
    dA = (np.pi / res) * (np.pi / res) * np.sin(TH).reshape(-1)
    Rm = np.asarray(R, dtype=np.float64)[:3, :3]
    b = np.asarray(_host(eval_basis(_f32(d, dev), bands)), dtype=np.float64)
    b_rot = np.asarray(_host(eval_basis(_f32(d @ Rm, dev), bands)), dtype=np.float64)
    # M[i, j] = sum over the grid of Y_i(w) Y_j(R^T w) dA
    M = (b * dA[:, None]).T @ b_rot
    return _f32(M, dev)


def sample_sh(coeffs: torch.Tensor, u: torch.Tensor, res: int = 32):
    """Importance-sample directions from a non-negative SH expansion via a
    2-D inverse CDF on an equal-area (cos theta, phi) grid.  u (N, 2) on
    the coefficients' device -> (dirs (N, 3), pdf (N,))."""
    dev = coeffs.device
    ct_edges = np.linspace(1.0, -1.0, res + 1)
    ct = 0.5 * (ct_edges[:-1] + ct_edges[1:])
    ph = (np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi
    CT, PH = np.meshgrid(ct, ph, indexing="ij")
    ST = np.sqrt(np.maximum(1 - CT * CT, 0.0))
    d = np.stack([ST * np.cos(PH), ST * np.sin(PH), CT], axis=-1).reshape(-1, 3)
    vals = np.maximum(_host(eval_sh(coeffs, _f32(d, dev))), 1e-9).reshape(res, 2 * res)
    cell_sa = (2.0 / res) * (2 * np.pi / (2 * res))  # equal-area cells
    pmf = vals / vals.sum()
    flat = _f32(pmf.reshape(-1), dev)
    cdf = cumsum_xla(flat)
    idx = torch.clamp(torch.searchsorted(cdf, u[..., 0].contiguous()), 0, res * 2 * res - 1)
    iy = idx // (2 * res)
    ix = idx % (2 * res)
    # uniform inside the chosen equal-area cell
    lo_prev = torch.where(idx > 0, cdf[torch.clamp_min(idx - 1, 0)], 0.0)
    frac = torch.clamp((u[..., 0] - lo_prev) / torch.clamp_min(cdf[idx] - lo_prev, 1e-12), 0, 1)
    ct_s = 1.0 - (iy + frac) * (2.0 / res)
    ph_s = (ix + u[..., 1]) * (2 * np.pi / (2 * res))
    st_s = torch.sqrt(torch.clamp_min(1 - ct_s * ct_s, 0.0))
    dirs = torch.stack([st_s * torch.cos(ph_s), st_s * torch.sin(ph_s), ct_s], dim=-1)
    pdf = flat[idx] / cell_sa
    return dirs, pdf
