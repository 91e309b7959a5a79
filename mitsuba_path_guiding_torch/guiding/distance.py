"""Guided distance sampling in participating media (port of the
reference's guiding/distance.py).

The ideal collision-distance density is p*(t) ~ Tr(t) sigma_s L_in(x(t)).
L_in is approximated by a per-cell scalar flux from the fitted guiding
cache; along each ray a piecewise-constant density over ``N_SEGMENTS``
equal segments (one cell lookup a segment) is one-sample-MIS'd against
the analytic exponential sampler by the integrator, so the estimator stays
unbiased where the cache is cold.  Arrays are laid out (S, N).
"""
from __future__ import annotations

import torch

from mitsuba_path_guiding_torch.guiding.grid import GuidingGrid, cell_index
from mitsuba_path_guiding_torch.models.medium import density_at

N_SEGMENTS = 16


def cell_flux(grid: GuidingGrid) -> torch.Tensor:
    """(C,) mean fitted sample weight (li / pdf) of each cell; 0 where a
    cell saw no sample."""
    total = torch.sum(grid.s_w, dim=-1)
    return total / torch.clamp_min(grid.s_count, 1.0)


def _segment_points(o, d, t1, n_seg):
    """Segment width dt (N,), midpoints t_mid (S, N) and their world
    points (S * N, 3)."""
    n = o.shape[0]
    dt = torch.clamp_min(t1, 0.0) / n_seg
    i_mid = torch.arange(n_seg, dtype=torch.float32, device=o.device) + 0.5
    t_mid = i_mid[:, None] * dt[None, :]
    px = o[:, 0][None] + t_mid * d[:, 0][None]
    py = o[:, 1][None] + t_mid * d[:, 1][None]
    pz = o[:, 2][None] + t_mid * d[:, 2][None]
    return dt, t_mid, torch.stack([px, py, pz], dim=-1).reshape(n_seg * n, 3)


def guided_distance_weights(grid: GuidingGrid, flux: torch.Tensor, o: torch.Tensor,
                            d: torch.Tensor, t1: torch.Tensor, sigma_bar: torch.Tensor,
                            n_seg: int = N_SEGMENTS, levels: int = 0):
    """Piecewise-constant importance over [0, t1] in ``n_seg`` equal
    segments: w_i = Tr(t_mid_i) flux(cell(x(t_mid_i))).

    Returns (w (S, N), dt (N,), total (N,)); total == 0 where the cache
    has nothing along the ray (the caller samples analytically there)."""
    n = o.shape[0]
    dt, t_mid, pos = _segment_points(o, d, t1, n_seg)
    cid = cell_index(grid, pos, levels=levels)
    v = flux[cid].reshape(n_seg, n)
    tr = torch.exp(-sigma_bar[None, :] * t_mid)
    w = tr * v
    total = torch.sum(w, dim=0)
    return w, dt, total


def guided_distance_weights_hetero(grid: GuidingGrid, flux: torch.Tensor, med, o: torch.Tensor,
                                   d: torch.Tensor, t1: torch.Tensor, n_seg: int = N_SEGMENTS,
                                   levels: int = 0):
    """``guided_distance_weights`` with the transmittance from a
    midpoint-Riemann optical depth of the density grid along the ray.

    Returns (w (S, N), dt (N,), total (N,), tr_end (N,)), tr_end ~ Tr(t1)
    (the surface-continuation probability)."""
    n = o.shape[0]
    dt, t_mid, pos = _segment_points(o, d, t1, n_seg)
    cid = cell_index(grid, pos, levels=levels)
    v = flux[cid].reshape(n_seg, n)
    base_t = torch.mean(med.sigma_a + med.sigma_s)
    sig = (density_at(med, pos) * base_t).reshape(n_seg, n)
    step_tau = sig * dt[None, :]
    tau_before = torch.cumsum(step_tau, dim=0) - step_tau
    tr_mid = torch.exp(-(tau_before + 0.5 * step_tau))
    tr_end = torch.exp(-torch.sum(step_tau, dim=0))
    w = tr_mid * v
    total = torch.sum(w, dim=0)
    return w, dt, total, tr_end


def piecewise_pdf(w: torch.Tensor, dt: torch.Tensor, total: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
    """Density at distances t (N,); 0 outside [0, S dt) and where total
    is 0."""
    s = w.shape[0]
    seg = torch.clamp(torch.floor(t / torch.clamp_min(dt, 1e-20)), 0, s - 1)
    seg = torch.clamp(seg.to(torch.int64), 0, s - 1)  # a NaN distance reads segment 0
    w_t = torch.take_along_dim(w, seg[None, :], dim=0)[0]
    pdf = w_t / torch.clamp_min(total * dt, 1e-30)
    in_range = (t >= 0.0) & (t < s * dt) & (total > 0.0)
    return torch.where(in_range, pdf, 0.0)


def piecewise_sample(w: torch.Tensor, dt: torch.Tensor, total: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Invert the piecewise-constant CDF with one uniform: the segment by
    a search of the scaled CDF, the place by the leftover fraction.
    Returns t (N,), meaningless where total == 0."""
    target = u * torch.clamp_min(total, 1e-30)
    cdf = torch.cumsum(w, dim=0)
    seg = torch.sum((target[None, :] >= cdf).to(torch.int64), dim=0)
    seg = torch.clamp(seg, 0, w.shape[0] - 1)[None, :]
    cdf_prev = torch.take_along_dim(cdf - w, seg, dim=0)[0]
    w_seg = torch.take_along_dim(w, seg, dim=0)[0]
    frac = torch.clamp((target - cdf_prev) / torch.clamp_min(w_seg, 1e-30), 0.0, 1.0 - 1e-6)
    return (seg[0].to(torch.float32) + frac) * dt
