"""Heterogeneous participating media: a grid density and null-collision
tracking (port of the reference's models/medium.py).

  - The density is a dense (D, H, W) grid with trilinear interpolation on
    its nodes; sigma_t(x) = density(x) (sigma_a + sigma_s).
  - Free-flight sampling is weighted delta tracking against the global
    majorant: tentative collisions at Exp(majorant) spacing, real with
    probability mean_c sigma_t_c(x) / majorant, with per-channel
    throughput weights that keep spectral media unbiased.
  - Shadow-ray transmittance is ratio tracking, with the same loop.

Both loops run over the whole wave until no lane is active (or
``MAX_TRACK_STEPS``).  Each lane draws step ``it`` from its own key folded
with ``it``, and a step leaves an inactive lane untouched, so a lane's
result does not depend on the others or on when the loop stops.  Whether
any lane is still active is read on the host only every ``ANY_EVERY``
steps (each read waits for the card).  Homogeneous media keep their
closed forms (``integrators/volpath.py``).
"""
from __future__ import annotations

import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.scene.types import MediumData

# Bound on the tracking steps of one call; with a correct majorant the
# loop ends once every lane has passed its segment's end.
MAX_TRACK_STEPS = 2048
# steps between the host's reads of "is any lane still active"
ANY_EVERY = 8


def density_at(med: MediumData, p: torch.Tensor) -> torch.Tensor:
    """Trilinear density at world points p (N, 3) -> (N,), on the grid's
    nodes (``density[z, y, x]``); 0 outside the medium's box."""
    ph = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
    q = (ph @ med.world_to_grid.T)[..., :3]
    inside = torch.all((q >= 0.0) & (q <= 1.0), dim=-1)
    D, H, W = med.density.shape
    x = q[..., 0] * (W - 1)
    y = q[..., 1] * (H - 1)
    z = q[..., 2] * (D - 1)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(W - 2, 0))
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, max(H - 2, 0))
    z0 = torch.clamp(torch.floor(z).to(torch.int64), 0, max(D - 2, 0))
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    fz = torch.clamp(z - z0, 0.0, 1.0)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    z1 = torch.clamp_max(z0 + 1, D - 1)
    g = med.density
    c00 = g[z0, y0, x0] * (1 - fx) + g[z0, y0, x1] * fx
    c01 = g[z0, y1, x0] * (1 - fx) + g[z0, y1, x1] * fx
    c10 = g[z1, y0, x0] * (1 - fx) + g[z1, y0, x1] * fx
    c11 = g[z1, y1, x0] * (1 - fx) + g[z1, y1, x1] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    d = c0 * (1 - fz) + c1 * fz
    return torch.where(inside, d, 0.0)


# ---------------------------------------------------------------------------
# point queries
# ---------------------------------------------------------------------------

def get_sigma_t(med: MediumData, p: torch.Tensor) -> torch.Tensor:
    """(N, 3) extinction at world points."""
    base = med.sigma_a + med.sigma_s
    if not med.heterogeneous:
        return torch.broadcast_to(base, p.shape[:-1] + (3,))
    return density_at(med, p)[..., None] * base


def get_sigma_s(med: MediumData, p: torch.Tensor) -> torch.Tensor:
    if not med.heterogeneous:
        return torch.broadcast_to(med.sigma_s, p.shape[:-1] + (3,))
    return density_at(med, p)[..., None] * med.sigma_s


def get_sigma_a(med: MediumData, p: torch.Tensor) -> torch.Tensor:
    if not med.heterogeneous:
        return torch.broadcast_to(med.sigma_a, p.shape[:-1] + (3,))
    return density_at(med, p)[..., None] * med.sigma_a


def get_albedo(med: MediumData, p: torch.Tensor) -> torch.Tensor:
    """Single-scattering albedo sigma_s / sigma_t (the density cancels)."""
    st = med.sigma_a + med.sigma_s
    alb = med.sigma_s / torch.clamp_min(st, 1e-20)
    return torch.broadcast_to(alb, p.shape[:-1] + (3,))


# ---------------------------------------------------------------------------
# null-collision tracking
# ---------------------------------------------------------------------------

def _track_keys(rkeys: torch.Tensor, depth: int, salt: int) -> torch.Tensor:
    """Each lane's key folded with ``salt + depth``."""
    return rng.fold_in(rkeys, int(salt) + int(depth))


def _grid_span(med: MediumData, o: torch.Tensor, d: torch.Tensor, t_max: torch.Tensor):
    """[0, t_max] clipped to the medium's box (a slab test in grid space);
    an empty span gives t0 == t1."""
    w2g = med.world_to_grid
    qo = o @ w2g[:3, :3].T + w2g[:3, 3]
    qd = d @ w2g[:3, :3].T
    inv = 1.0 / torch.where(torch.abs(qd) < 1e-12, torch.where(qd >= 0, 1e-12, -1e-12), qd)
    ta = (0.0 - qo) * inv
    tb = (1.0 - qo) * inv
    t0 = torch.amax(torch.minimum(ta, tb), dim=-1)
    t1 = torch.amin(torch.maximum(ta, tb), dim=-1)
    t0 = torch.clamp_min(t0, 0.0)
    t1 = torch.minimum(t1, t_max)
    return t0, torch.maximum(t1, t0)


def _step_uniform(tkeys: torch.Tensor, it: int, n: int) -> torch.Tensor:
    """(N, n) uniforms of step ``it``: each lane's key folded with it."""
    return rng.uniform(rng.fold_in(tkeys, it), n)


def _go_on(it: int, active: torch.Tensor) -> bool:
    """The tracking loops' condition: below MAX_TRACK_STEPS, and some lane
    active, read on the host at every ANY_EVERY-th step only."""
    return it < MAX_TRACK_STEPS and (it % ANY_EVERY != 0 or bool(active.any()))


def sample_free_flight(med: MediumData, o: torch.Tensor, d: torch.Tensor, t_max: torch.Tensor,
                       tkeys: torch.Tensor):
    """Weighted delta tracking along o + t d for t in (0, t_max).

    Returns (t_event (N,), is_medium (N,), weight (N, 3)); ``weight``
    multiplies the path throughput: sigma_s(x) / (majorant P_real) on a
    medium event, the product of the null-collision ratios on a lane that
    passed its segment (expected value Tr / P(pass))."""
    n = o.shape[0]
    base_t = med.sigma_a + med.sigma_s
    maj = torch.clamp_min(med.majorant, 1e-12)
    t_lo, t_hi = _grid_span(med, o, d, t_max)
    t, active, it = t_lo, t_hi > t_lo, 0
    w = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    is_med = torch.zeros((n,), dtype=torch.bool, device=o.device)
    while _go_on(it, active):
        u = _step_uniform(tkeys, it, 2)
        dt = -torch.log(torch.clamp_min(1.0 - u[..., 0], 1e-12)) / maj
        t_new = t + dt
        passed = t_new >= t_hi
        x = o + t_new[..., None] * d
        dens = density_at(med, x)
        sig_t = dens[..., None] * base_t
        p_real = torch.clamp(torch.mean(sig_t, dim=-1) / maj, 0.0, 1.0)
        real = (~passed) & (u[..., 1] < p_real)
        null = (~passed) & ~real
        w_real = (dens[..., None] * med.sigma_s[None, :]) / torch.clamp_min(
            maj * p_real, 1e-20)[..., None]
        w_null = (maj - sig_t) / torch.clamp_min(maj * (1.0 - p_real), 1e-20)[..., None]
        w = torch.where((active & real)[..., None], w * w_real,
                        torch.where((active & null)[..., None], w * w_null, w))
        is_med = torch.where(active & real, True, is_med)
        t = torch.where(active, t_new, t)
        active = active & null
        it += 1
    t = torch.where(is_med, torch.minimum(t, t_hi), t_max)
    return t, is_med, w


def transmittance_ratio(med: MediumData, o: torch.Tensor, d: torch.Tensor, t_max: torch.Tensor,
                        tkeys: torch.Tensor) -> torch.Tensor:
    """Ratio-tracking transmittance (N, 3) along shadow rays; a lane whose
    weight falls below 1e-5 in every channel stops at 0 (bias below 1e-5
    a channel)."""
    n = o.shape[0]
    base_t = med.sigma_a + med.sigma_s
    maj = torch.clamp_min(med.majorant, 1e-12)
    t_lo, t_hi = _grid_span(med, o, d, t_max)
    t, active, it = t_lo, t_hi > t_lo, 0
    w = torch.ones((n, 3), dtype=torch.float32, device=o.device)
    while _go_on(it, active):
        u = _step_uniform(tkeys, it, 1)
        dt = -torch.log(torch.clamp_min(1.0 - u[..., 0], 1e-12)) / maj
        t_new = t + dt
        passed = t_new >= t_hi
        x = o + t_new[..., None] * d
        sig_t = density_at(med, x)[..., None] * base_t
        ratio = torch.clamp_min(1.0 - sig_t / maj, 0.0)
        w = torch.where((active & ~passed)[..., None], w * ratio, w)
        dead = torch.amax(w, dim=-1) < 1e-5
        w = torch.where((active & dead)[..., None], 0.0, w)
        t = torch.where(active, t_new, t)
        active = active & ~passed & ~dead
        it += 1
    return w
