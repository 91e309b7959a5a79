"""Volume photon map and beam radiance estimate (port of the reference's
integrators/volphoton.py).

``volume_photon_pass`` shoots a light wave through the scene's medium,
depositing a volume photon at every medium scattering event and going on
by phase sampling; photons end at surfaces (the volume map carries medium
transport only).  Free flights are closed form in a homogeneous medium
(the mean extinction's density) and weighted delta tracking
(``models.medium.sample_free_flight``) in a grid medium.

``beam_estimate`` gathers along each camera segment at ``n_taps``
stratified points: at each, a ball gather in ``integrators.sppm``'s
sorted grid (photon order from key 23), weighted by the transmittance to
the point, the phase function and the constant kernel 1 / (4/3 pi r^3).
Queries route as ``integrators.path.route_dense_or_bvh``.
"""
from __future__ import annotations

import math

import torch

from mitsuba_path_guiding_torch.core.rng import bounce_uniform, event_uniform
from mitsuba_path_guiding_torch.integrators.path import INFD, route_dense_or_bvh
from mitsuba_path_guiding_torch.integrators.ptracer import TAG_EMITTER_RAY
from mitsuba_path_guiding_torch.integrators.sppm import (
    cell_segments,
    cell_taps,
    grid_params,
    sort_photons,
)
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.medium import _track_keys, sample_free_flight
from mitsuba_path_guiding_torch.models.phase import phase_eval, phase_sample

MAX_CELL_TAPS = 16
TAG_TRACK_PHOTON = 977
PHOTON_ORDER_SEED = 23


def volume_photon_pass(scene, rkeys, max_depth: int = 8, accel: str = "auto",
                       em_kinds=em_mod.PORTED_KINDS, hetero: bool = False):
    """A light wave through the medium, one photon a key.  Returns the
    deposits of every bounce flattened (depth-major): (pos (D M, 3), the
    propagation direction at the event (D M, 3), power (D M, 3), ok
    (D M,))."""
    med = scene.medium
    intersect, _ = route_dense_or_bvh(scene, accel)
    rs = em_mod.sample_ray(scene.emitters, scene.aabb_min, scene.aabb_max,
                           event_uniform(rkeys, TAG_EMITTER_RAY, 5), kinds=em_kinds)
    o, d = rs.o, rs.d
    T = torch.where(rs.valid[..., None], rs.weight, 0.0)
    alive = rs.valid
    sigma_t = med.sigma_a + med.sigma_s
    sigma_s = med.sigma_s
    outs = []
    for depth in range(max_depth):
        u = bounce_uniform(rkeys, depth, 4)
        hit = intersect(o, d, torch.where(alive, INFD, -1.0))
        # a finished photon's segment is empty (its deposits are off)
        t_surf = torch.where(hit.valid, hit.t, torch.where(alive, 1e30, 0.0))
        if hetero:
            t_med, is_med_ev, w_ff = sample_free_flight(
                med, o, d, t_surf, _track_keys(rkeys, depth, TAG_TRACK_PHOTON))
        else:
            # closed-form spectral free flight sampled by the mean extinction
            sbar = torch.clamp_min(torch.mean(sigma_t), 1e-12)
            t_med = -torch.log(torch.clamp_min(1.0 - u[..., 2], 1e-12)) / sbar
            is_med_ev = t_med < t_surf
            tt = torch.minimum(t_med, t_surf)[..., None]
            tr_rgb = torch.exp(-sigma_t[None, :] * tt)
            w_ev = sigma_s[None, :] * tr_rgb / (sbar * torch.exp(-sbar * tt))
            w_pass = tr_rgb / torch.exp(-sbar * tt)
            w_ff = torch.where(is_med_ev[..., None], w_ev, w_pass)
        is_medium = alive & is_med_ev
        T = T * w_ff  # sigma_s / (majorant p) at events; the null ratios on passes
        p = o + t_med[..., None] * d
        outs.append((p, d, T, is_medium))
        # on by phase sampling from medium events; photons that reach a
        # surface or escape end
        wo, _ = phase_sample(-d, med.phase_g, u[..., 0:2])
        o, d, alive = p, wo, is_medium
    pos, wdir, pw, ok = (torch.cat(x) for x in zip(*outs))
    return pos, wdir, pw, ok


def build_vol_grid(scene, r: float):
    """(lo, 1 / cell, G): a grid whose 2 x 2 x 2 cells hold an r-ball."""
    return grid_params(scene, 2.0 * r)


def beam_estimate(scene, o, d, t_seg, taps_u, ph_pos, ph_dir, ph_pw, ph_ok, lo,
                  inv_cell: float, g: int, r: float, n_emitted: int, n_taps: int = 16):
    """In-scattered radiance along each camera segment [0, t_seg]: (N, 3).
    ``taps_u`` (n_taps, N) places the taps in their strata; the
    transmittance is the homogeneous medium's."""
    med = scene.medium
    sigma_t = med.sigma_a + med.sigma_s
    n = o.shape[0]
    sp = sort_photons(ph_pos, ph_dir, ph_pw, ph_ok, lo, inv_cell, g, seed=PHOTON_ORDER_SEED)
    r_t = torch.tensor(r, dtype=torch.float32, device=o.device)
    kernel = 1.0 / (4.0 / 3.0 * math.pi * (r_t * r_t * r_t))
    r2 = r_t * r_t
    taps = torch.arange(MAX_CELL_TAPS, device=o.device)
    L = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    dt = t_seg / n_taps
    for it in range(n_taps):
        t_i = (it + taps_u[it]) * dt
        x = o + t_i[..., None] * d
        tr = torch.exp(-sigma_t[None, :] * t_i[..., None])
        acc = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
        for start, end in cell_segments(sp, x, lo, inv_cell, g):
            # a cell's taps at once, added in the reference's order
            idx, okk, scale = cell_taps(sp, start, end, taps)
            dp = sp.pos[idx] - x[:, None, :]
            sel = okk & (torch.sum(dp * dp, dim=-1) <= r2)
            ph = phase_eval(-sp.dir[idx], -d[:, None, :], med.phase_g)
            w = torch.where(sel, scale[:, None] * ph, 0.0)[..., None] * sp.pw[idx]
            for j in range(MAX_CELL_TAPS):
                acc = acc + w[:, j]
        L = L + tr * acc * (kernel * dt[..., None])
    return L / n_emitted
