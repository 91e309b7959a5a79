"""Weighted-EM fitting of the vMF-mixture guiding cache from path records,
and its adaptive spatial refinement (port of the reference's
guiding/fit.py ``accumulate_stats``, ``update_grid``, ``fit_from_records``
and ``refine_grid``).

The statistics are linear in the samples, so they add across waves
before one parameter update per progression.  The per-cell sums of an
(M, 5K+5) payload are added in an order that does not depend on the run
(``cell_sums``), so a fit, and every guided sample drawn from it, repeats
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_path_guiding_torch.core.math import scatter_add_rows
from mitsuba_path_guiding_torch.core.vmf import mean_cosine_to_kappa
from mitsuba_path_guiding_torch.guiding.grid import (
    MAX_REFINE_LEVELS,
    GuidingGrid,
    _gather_cells,
    _vmf_pdf_kn,
    cell_index,
)
from mitsuba_path_guiding_torch.utils.stats import host_read

MIN_SAMPLES_VALID = 32.0
ALPHA_R_LO = 0.2
ALPHA_R_HI = 0.6
EMA = 0.7
WEIGHT_FLOOR = 1e-3
KAPPA_FIT_MAX = 5e3


def cell_sums(n_cells: int, cid, payload):
    """(n_cells, W) sums of the (M, W) payload rows by cell id, in an order
    fixed by the data (``core.math.scatter_add_rows``)."""
    summed = torch.zeros((n_cells, payload.shape[1]), dtype=payload.dtype, device=payload.device)
    return scatter_add_rows(summed, cid, payload)


def accumulate_stats(grid: GuidingGrid, rec, levels: int | None = None):
    """One E-step and the local statistics of a PathRecord batch.
    Returns (s_w, s_dir, s_count, s_rho, s_pos, s_pos_w)."""
    d_axis, _, n_axis = rec.pos.shape
    m = d_axis * n_axis
    px = rec.pos[:, 0, :].reshape(m)
    py = rec.pos[:, 1, :].reshape(m)
    pz = rec.pos[:, 2, :].reshape(m)
    dx = rec.dir[:, 0, :].reshape(m)
    dy = rec.dir[:, 1, :].reshape(m)
    dz = rec.dir[:, 2, :].reshape(m)
    li = rec.li.reshape(m)
    pdf = rec.pdf.reshape(m)
    valid = rec.valid.reshape(m)

    w_sample = torch.where(valid, li / torch.clamp_min(pdf, 1e-3), 0.0)
    w_sample = torch.clamp_max(w_sample, 1e4)
    pos = torch.stack([px, py, pz], dim=-1)
    cid = cell_index(grid, pos, levels=MAX_REFINE_LEVELS if levels is None else levels)

    w_mix, mux, muy, muz, kappa, cell_valid = _gather_cells(grid, cid)
    t = mux * dx[None] + muy * dy[None] + muz * dz[None]
    p_k = torch.clamp_min(_vmf_pdf_kn(t, kappa), 1e-12)
    resp = w_mix * p_k
    resp = resp / torch.clamp_min(torch.sum(resp, dim=0, keepdim=True), 1e-12)
    resp = torch.where(cell_valid[None, :], resp, 1.0 / resp.shape[0])

    rw = resp * w_sample[None, :]
    c, k = grid.kappa.shape
    if rec.dist is not None:
        dist = rec.dist.reshape(m)
        inv_d = torch.where((dist > 1e-5) & (dist < 1e7), 1.0 / dist, 0.0)
    else:
        inv_d = torch.zeros((m,), device=li.device)
    payload = torch.cat(
        [
            rw.T,
            (rw * dx[None]).T,
            (rw * dy[None]).T,
            (rw * dz[None]).T,
            valid.to(torch.float32)[:, None],
            (rw * inv_d[None]).T,
            (w_sample * px)[:, None],
            (w_sample * py)[:, None],
            (w_sample * pz)[:, None],
            w_sample[:, None],
        ],
        dim=1,
    )
    summed = cell_sums(c, cid, payload)
    s_w = summed[:, 0:k]
    s_dir = torch.stack(
        [summed[:, k: 2 * k], summed[:, 2 * k: 3 * k], summed[:, 3 * k: 4 * k]], dim=-1)
    s_count = summed[:, 4 * k]
    s_rho = summed[:, 4 * k + 1: 5 * k + 1]
    s_pos = summed[:, 5 * k + 1: 5 * k + 4]
    s_pos_w = summed[:, 5 * k + 4]
    return s_w, s_dir, s_count, s_rho, s_pos, s_pos_w


def update_grid(grid: GuidingGrid, s_w, s_dir, s_count,
                s_rho=None, s_pos=None, s_pos_w=None) -> GuidingGrid:
    """M-step: blend statistics (EMA) and recompute mixture parameters."""
    s_w_t = grid.s_w * EMA + s_w
    s_dir_t = grid.s_dir * EMA + s_dir
    s_count_t = grid.s_count * EMA + s_count

    total_w = torch.sum(s_w_t, dim=-1, keepdim=True)
    has_data = (total_w[..., 0] > 1e-9) & (s_count_t > MIN_SAMPLES_VALID)

    new_weight = s_w_t / torch.clamp_min(total_w, 1e-12)
    new_weight = torch.clamp_min(new_weight, WEIGHT_FLOOR)
    new_weight = new_weight / torch.sum(new_weight, dim=-1, keepdim=True)

    norm_dir = torch.linalg.norm(s_dir_t, dim=-1)
    r = norm_dir / torch.clamp_min(s_w_t, 1e-12)
    new_kappa = torch.clamp(mean_cosine_to_kappa(r), 1e-2, KAPPA_FIT_MAX)
    new_mu = s_dir_t / torch.clamp_min(norm_dir, 1e-12)[..., None]

    res_vec = torch.sum(s_dir_t, dim=1)
    r_bar = torch.linalg.norm(res_vec, dim=-1) / torch.clamp_min(total_w[..., 0], 1e-12)
    alpha_scale = torch.clamp((r_bar - ALPHA_R_LO) / (ALPHA_R_HI - ALPHA_R_LO), 0.0, 1.0)

    lobe_ok = (s_w_t > 1e-9) & (norm_dir > 1e-12)
    mu = torch.where(lobe_ok[..., None], new_mu, grid.mu)
    kappa = torch.where(lobe_ok, new_kappa, grid.kappa)

    extra = {}
    if s_rho is not None and grid.s_rho is not None:
        s_rho_t = grid.s_rho * EMA + s_rho
        lobe_dist = torch.where(s_rho_t > 1e-9, s_w_t / torch.clamp_min(s_rho_t, 1e-12), 0.0)
        s_pos_t = grid.s_pos * EMA + s_pos
        s_pos_w_t = grid.s_pos_w * EMA + s_pos_w
        origin = torch.where(
            (s_pos_w_t > 1e-9)[:, None],
            s_pos_t / torch.clamp_min(s_pos_w_t, 1e-12)[:, None],
            grid.origin,
        )
        extra = dict(s_rho=s_rho_t, s_pos=s_pos_t, s_pos_w=s_pos_w_t,
                     origin=origin, lobe_dist=lobe_dist)
    return grid._replace(
        mu=mu,
        kappa=kappa,
        log_weight=torch.log(new_weight),
        valid=has_data,
        s_w=s_w_t,
        s_dir=s_dir_t,
        s_count=s_count_t,
        alpha_scale=alpha_scale,
        **extra,
    )


def fit_from_records(grid: GuidingGrid, rec, mesh=None) -> GuidingGrid:
    """One full fitting step: the statistics of ``rec`` and the M-step.
    With a ``mesh`` (``parallel.mesh.make_device_mesh``; the reference's
    ``psum_axis``) the six statistics are summed over its ranks, in rank
    order, before the update, so every rank makes the same grid."""
    stats = accumulate_stats(grid, rec)
    if mesh is not None:
        from mitsuba_path_guiding_torch.parallel.mesh import merge_stats

        stats = merge_stats(tuple(x[None] for x in stats), mesh)
    return update_grid(grid, *stats)


SPLIT_THRESHOLD = 4096.0  # samples before a cell subdivides


def _host(x):
    return host_read(x, "fit.refine_grid").numpy()


def refine_grid(grid: GuidingGrid, threshold: float = SPLIT_THRESHOLD) -> GuidingGrid:
    """Host-side adaptive refinement between progressions (the SD-tree
    split of Practical Path Guiding on fixed-capacity flat tables): each
    leaf in use whose accumulated sample count exceeds ``threshold``, above
    the deepest level, gets 8 children appended at ``n_used``, seeded with
    its mixture and 1/8 of its statistics; the highest counts split first
    while capacity lasts.  The tables go to the host and back to the
    grid's device; the topology is frozen again afterwards."""
    child_base = _host(grid.child_base).copy()
    level = _host(grid.level).copy()
    count = _host(grid.s_count)
    n_used = int(grid.n_used)
    capacity = child_base.shape[0]

    is_leaf = child_base < 0
    in_use = np.arange(capacity) < n_used
    want = in_use & is_leaf & (count > threshold) & (level < MAX_REFINE_LEVELS)
    idx = np.nonzero(want)[0]
    if idx.size == 0 or n_used >= capacity:
        return grid
    # the reference's numpy argsort (unstable quicksort): equal counts are
    # common, and a capacity cut must keep the same cells
    idx = idx[np.argsort(-count[idx])]
    n_fit = min(idx.size, (capacity - n_used) // 8)
    if n_fit == 0:
        return grid
    idx = idx[:n_fit]

    copied = ("mu", "kappa", "log_weight", "valid", "alpha_scale", "origin", "lobe_dist")
    scaled = ("s_w", "s_dir", "s_count", "s_rho", "s_pos", "s_pos_w")
    host = {f: _host(getattr(grid, f)).copy() for f in copied + scaled
            if getattr(grid, f) is not None}
    for parent in idx:
        child_base[parent] = n_used
        rows = slice(n_used, n_used + 8)
        child_base[rows] = -1
        level[rows] = level[parent] + 1
        for f, a in host.items():
            a[rows] = a[parent] / 8.0 if f in scaled else a[parent]
        n_used += 8

    dev = grid.child_base.device
    return grid._replace(child_base=torch.from_numpy(child_base).to(dev),
                         level=torch.from_numpy(level).to(dev), n_used=n_used,
                         **{f: torch.from_numpy(a).to(dev) for f, a in host.items()})
