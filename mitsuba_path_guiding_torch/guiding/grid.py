"""Spatio-directional guiding cache: a uniform spatial grid of K-lobe vMF
mixtures (port of the reference's guiding/grid.py).

All state is flat tensors: lookups are index math and gathers, mixture
evaluation and sampling are batched elementwise work in a (K, N) layout.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.math import normalize
from mitsuba_path_guiding_torch.core.vmf import vmf_sample
from mitsuba_path_guiding_torch.core.warp import INV_FOURPI

MAX_REFINE_LEVELS = 3  # static octree walk depth below the root grid


class GuidingGrid(NamedTuple):
    """Mixture parameters per cell (C rows, K lobes); field meanings are
    the reference's."""

    mu: torch.Tensor          # (C, K, 3)
    kappa: torch.Tensor       # (C, K)
    log_weight: torch.Tensor  # (C, K)
    valid: torch.Tensor       # (C,) bool
    s_w: torch.Tensor         # (C, K)
    s_dir: torch.Tensor       # (C, K, 3)
    s_count: torch.Tensor     # (C,)
    aabb_min: torch.Tensor    # (3,)
    aabb_max: torch.Tensor    # (3,)
    child_base: torch.Tensor  # (C,) int32, -1 leaf
    level: torch.Tensor       # (C,) int32
    res0: int                 # root resolution (host int)
    n_used: int               # rows in use (host int)
    s_rho: torch.Tensor = None
    s_pos: torch.Tensor = None
    s_pos_w: torch.Tensor = None
    origin: torch.Tensor = None
    lobe_dist: torch.Tensor = None
    alpha_scale: torch.Tensor = None


# XLA's float32 erf_inv (Giles' single-precision polynomial): Horner
# coefficients in w = -log1p(-x^2) - 2.5 below w = 5, and in
# sqrt(w) - 3 from there on
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once, as a fused multiply-add
    (XLA on the CPU contracts these steps): the product is exact in
    float64."""
    return (a.double() * b.double() + c.double()).float()


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coef(i))
    return torch.where(torch.abs(x) == 1.0, x * torch.finfo(torch.float32).max, p * x)


def _normal_bits_to_float(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.normal's transform of uint32 bits: a uniform in
    (-1, 1) -> sqrt(2) erfinv(u), in XLA's float32 arithmetic (its
    erf_inv polynomial, its contracted multiply-adds); log1p may still
    differ from XLA's by an ulp."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    f = rng.bits_to_unit(bits)
    u = torch.clamp_min(_fma32(f, torch.full_like(f, float(np.float32(1.0) - lo)),
                               torch.full_like(f, float(lo))), float(lo))
    return _erfinv32(u) * float(np.float32(math.sqrt(2.0)))


def make_grid(aabb_min, aabb_max, res: int = 16, n_lobes: int = 8, seed: int = 0,
              capacity: int | None = None, device=None) -> GuidingGrid:
    """Cold-start grid: lobes drawn from jax.random.normal(PRNGKey(seed))
    and normalised, kappa 1, uniform weights."""
    if torch.is_tensor(aabb_min):
        device = aabb_min.device if device is None else device
        aabb_min = aabb_min.detach().cpu().numpy()
        aabb_max = aabb_max.detach().cpu().numpy()
    c0 = res**3
    c = max(capacity if capacity is not None else c0, c0)
    key = rng.base_key(seed, device=device)
    bits = rng.random_bits(key, c * n_lobes * 3)
    mu = normalize(_normal_bits_to_float(bits).reshape(c, n_lobes, 3))
    lo = np.asarray(aabb_min, dtype=np.float32)
    hi = np.asarray(aabb_max, dtype=np.float32)
    ijk = np.stack(np.meshgrid(*(np.arange(res),) * 3, indexing="ij"), -1)
    centers = lo + (ijk.reshape(-1, 3) + 0.5) / res * (hi - lo)
    org = np.zeros((c, 3), dtype=np.float32)
    org[: res**3] = centers
    f32 = dict(dtype=torch.float32, device=device)
    return GuidingGrid(
        mu=mu,
        kappa=torch.full((c, n_lobes), 1.0, **f32),
        log_weight=torch.zeros((c, n_lobes), **f32),
        valid=torch.zeros((c,), dtype=torch.bool, device=device),
        s_w=torch.zeros((c, n_lobes), **f32),
        s_dir=torch.zeros((c, n_lobes, 3), **f32),
        s_count=torch.zeros((c,), **f32),
        aabb_min=torch.as_tensor(lo, **f32),
        aabb_max=torch.as_tensor(hi, **f32),
        child_base=torch.full((c,), -1, dtype=torch.int32, device=device),
        level=torch.zeros((c,), dtype=torch.int32, device=device),
        res0=int(res),
        n_used=int(c0),
        s_rho=torch.zeros((c, n_lobes), **f32),
        s_pos=torch.zeros((c, 3), **f32),
        s_pos_w=torch.zeros((c,), **f32),
        origin=torch.as_tensor(org, **f32),
        lobe_dist=torch.zeros((c, n_lobes), **f32),
        alpha_scale=torch.ones((c,), **f32),
    )


def cell_index(grid: GuidingGrid, p: torch.Tensor, levels: int = MAX_REFINE_LEVELS) -> torch.Tensor:
    """(N, 3) world positions -> (N,) int64 cell rows (leaf of the octree
    walk; ``levels`` walk iterations)."""
    res = grid.res0
    extent = torch.clamp_min(grid.aabb_max - grid.aabb_min, 1e-6)
    q = torch.clamp((p - grid.aabb_min) / extent, 0.0, 1.0 - 1e-6) * res
    ijk = q.to(torch.int64)
    cid = (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2]
    frac = q - ijk
    for _ in range(levels):
        base = grid.child_base[cid].to(torch.int64)
        hi = (frac >= 0.5).to(torch.int64)
        octant = (hi[..., 0] * 2 + hi[..., 1]) * 2 + hi[..., 2]
        cid = torch.where(base >= 0, base + octant, cid)
        frac = torch.where((base >= 0)[..., None], frac * 2.0 - hi, frac)
    return cid


def active_levels(grid: GuidingGrid) -> int:
    """Octree walk depth this grid's topology needs (host read)."""
    return MAX_REFINE_LEVELS if bool((grid.child_base >= 0).any()) else 0


def mixture_weights(grid: GuidingGrid, cid: torch.Tensor) -> torch.Tensor:
    """(N, K) normalised lobe weights of cells cid."""
    return torch.softmax(grid.log_weight[cid], dim=-1)


def _gather_cells(grid: GuidingGrid, cid: torch.Tensor, with_alpha: bool = False):
    """One packed column gather of per-cell parameters, rounded through
    bf16 as the reference does (sampling and pdf read the same rounded
    values).  Returns (w (K,N) softmaxed, mux, muy, muz, kappa, valid (N,))
    [, alpha_scale (N,)]."""
    c, k = grid.kappa.shape
    rows = [
        grid.mu[..., 0].T,
        grid.mu[..., 1].T,
        grid.mu[..., 2].T,
        grid.kappa.T,
        grid.log_weight.T,
        grid.valid[None, :].to(torch.float32),
    ]
    if with_alpha:
        a_row = grid.alpha_scale if grid.alpha_scale is not None else torch.ones(
            (c,), device=cid.device)
        rows.append(a_row[None, :].to(torch.float32))
    packed = torch.cat(rows, dim=0)
    rows = packed.to(torch.bfloat16)[:, cid].to(torch.float32)
    mux, muy, muz = rows[0:k], rows[k: 2 * k], rows[2 * k: 3 * k]
    kappa = rows[3 * k: 4 * k]
    logw = rows[4 * k: 5 * k]
    valid = rows[5 * k] > 0.5
    w = torch.softmax(logw, dim=0)
    if with_alpha:
        return (w, mux, muy, muz, kappa, valid), rows[5 * k + 1]
    return w, mux, muy, muz, kappa, valid


def _vmf_pdf_kn(t, kappa):
    """vMF pdf from cos angle t and kappa, all (K, N), exp-normalised."""
    kk = torch.clamp(kappa, 0.0, 1e4)
    denom = 2.0 * math.pi * -torch.expm1(-2.0 * kk)
    norm = torch.where(kk > 1e-6, kk / torch.clamp_min(denom, 1e-30), INV_FOURPI)
    return norm * torch.exp(kk * (torch.clamp(t, -1.0, 1.0) - 1.0))


def _mixture_pdf(params, d):
    w, mux, muy, muz, kappa, valid = params
    t = mux * d[..., 0][None] + muy * d[..., 1][None] + muz * d[..., 2][None]
    pdf = torch.sum(w * _vmf_pdf_kn(t, kappa), dim=0)
    return torch.where(valid, pdf, INV_FOURPI)


def guide_pdf(grid: GuidingGrid, cid: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Mixture pdf of world direction d at cells cid (solid-angle measure)."""
    return _mixture_pdf(_gather_cells(grid, cid), d)


def _mixture_sample(params, u_lobe, u2):
    w, mux, muy, muz, kappa, valid = params
    cdf = torch.cumsum(w, dim=0)
    ksel = torch.sum((u_lobe[None, :] > cdf).to(torch.int64), dim=0)
    ksel = torch.clamp(ksel, 0, w.shape[0] - 1)[None, :]
    mu_k = torch.stack(
        [mux.gather(0, ksel)[0], muy.gather(0, ksel)[0], muz.gather(0, ksel)[0]], dim=-1)
    kappa_k = kappa.gather(0, ksel)[0]
    d = vmf_sample(u2, mu_k, kappa_k)
    z = 1.0 - 2.0 * u2[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u2[..., 1]
    d_uni = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return torch.where(valid[..., None], d, d_uni)


def guide_sample(grid: GuidingGrid, cid: torch.Tensor, u_lobe, u2) -> torch.Tensor:
    """A world direction drawn from the mixture of each cell."""
    return _mixture_sample(_gather_cells(grid, cid), u_lobe, u2)


def guide_sample_pdf(grid: GuidingGrid, cid: torch.Tensor, u_lobe, u2, d_other):
    """(sample, pdf(sample), pdf(d_other)) from one parameter gather."""
    params = _gather_cells(grid, cid)
    d = _mixture_sample(params, u_lobe, u2)
    return d, _mixture_pdf(params, d), _mixture_pdf(params, d_other)


# cosine-lobe vMF proxy: the mean cosine of cos(theta)/pi over the
# hemisphere is 2/3, so kappa ~ 2.25 (core/vmf.py mean_cosine_to_kappa)
KAPPA_COSINE = 2.25


def product_params(params, n_world: torch.Tensor, kappa_b: float = KAPPA_COSINE):
    """The product of the cell mixture with a vMF(n, kappa_b) cosine proxy,
    again a proper mixture: per lobe the integral factor is
    N(ka) N(kb) / N(kc) exp(kc - ka - kb), with N the exp-normalised vMF
    constant.  Sampling and pdf both read these parameters, so the
    one-sample MIS estimator stays exact.  The reference's order of
    operations, clamps and floors."""
    w, mux, muy, muz, kappa, valid = params
    nx, ny, nz = n_world[..., 0][None], n_world[..., 1][None], n_world[..., 2][None]
    vx = kappa * mux + kappa_b * nx
    vy = kappa * muy + kappa_b * ny
    vz = kappa * muz + kappa_b * nz
    kc = torch.sqrt(vx * vx + vy * vy + vz * vz)
    kc_safe = torch.clamp_min(kc, 1e-9)
    muxc, muyc, muzc = vx / kc_safe, vy / kc_safe, vz / kc_safe

    def _logN(k):
        kk = torch.clamp(k, 1e-6, 1e4)
        return torch.log(kk) - math.log(2.0 * math.pi) - torch.log(-torch.expm1(-2.0 * kk))

    log_lambda = _logN(kappa) + _logN(torch.full_like(kappa, kappa_b)) - _logN(kc) + (
        kc - kappa - kappa_b)
    w_new = w * torch.exp(torch.clamp(log_lambda, -60.0, 60.0))
    w_new = w_new / torch.clamp_min(torch.sum(w_new, dim=0, keepdim=True), 1e-30)
    return (w_new, muxc, muyc, muzc, kc, valid)


def parallax_params(grid: GuidingGrid, cid, params, p):
    """Re-aim each lobe at its fitted virtual source origin + mu * dist
    from the query point p (lobes without distance data keep their
    mean)."""
    if grid.lobe_dist is None:
        return params
    w, mux, muy, muz, kappa, valid = params
    k = grid.kappa.shape[1]
    packed = torch.cat([grid.lobe_dist.T, grid.origin.T], dim=0)
    rows = packed[:, cid]
    dist = rows[0:k]
    org = rows[k: k + 3]
    ok = (dist > 1e-5) & (dist < 1e7) & valid[None, :]
    vx = org[0][None] + mux * dist - p[..., 0][None]
    vy = org[1][None] + muy * dist - p[..., 1][None]
    vz = org[2][None] + muz * dist - p[..., 2][None]
    norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
    ok = ok & (norm > 1e-6)
    inv = 1.0 / torch.clamp_min(norm, 1e-6)
    return (
        w,
        torch.where(ok, vx * inv, mux),
        torch.where(ok, vy * inv, muy),
        torch.where(ok, vz * inv, muz),
        kappa,
        valid,
    )
