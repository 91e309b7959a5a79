"""Phase functions: isotropic, Henyey-Greenstein, Rayleigh, Kajiya-Kay,
microflake and weighted mixtures of the classic families (port of the
reference's models/phase.py).

Convention of the reference: ``wi`` points toward the previous vertex,
``wo`` away from the collision; HG's g > 0 scatters forward, i.e. the pdf
peaks at wo ~ -wi (cos(theta) = dot(-wi, wo)).  HG, Rayleigh and the
mixture are sampled exactly (eval == pdf, weight 1); Kajiya-Kay and the
microflake return a weight.  The medium's host-side ``phase_kind`` picks
the family (``PhaseKind``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.math import Frame, dot
from mitsuba_path_guiding_torch.core.warp import INV_FOURPI, square_to_uniform_sphere
from mitsuba_path_guiding_torch.guiding.grid import _erfinv32


class PhaseKind:
    HG = 0          # isotropic where g == 0
    RAYLEIGH = 1
    KKAY = 2        # Kajiya-Kay fiber phase, uniform sampling
    MICROFLAKE = 3  # specular flakes, Gaussian fiber distribution
    MIXTURE = 4     # normalised weighted HG / isotropic / Rayleigh components


def hg_pdf(cos_theta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """p = (1 - g^2) / (4 pi (1 + g^2 - 2 g cos)^1.5), cos = dot(-wi, wo)."""
    g = torch.clamp(g, -0.999, 0.999)
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOURPI * (1.0 - g * g) / torch.clamp_min(
        denom * torch.sqrt(torch.clamp_min(denom, 1e-12)), 1e-12)


def phase_eval(wi: torch.Tensor, wo: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """pdf == eval; isotropic where |g| ~ 0."""
    c = dot(-wi, wo)
    return torch.where(torch.abs(g) < 1e-4, INV_FOURPI, hg_pdf(c, g))


def phase_sample(wi: torch.Tensor, g: torch.Tensor, u: torch.Tensor):
    """Sample wo about the forward direction -wi; returns (wo, pdf).
    u: (..., 2)."""
    g = torch.clamp(g, -0.999, 0.999)
    # the HG inverse CDF, with a sign-keeping guard on 2g
    sqr = (1.0 - g * g) / (1.0 - g + 2.0 * g * u[..., 0])
    two_g = torch.where(torch.abs(g) < 1e-6, 1e-6, 2.0 * g)
    cos_t_hg = (1.0 + g * g - sqr * sqr) / two_g
    cos_t_iso = 1.0 - 2.0 * u[..., 0]
    iso = torch.abs(g) < 1e-4
    cos_t = torch.where(iso, cos_t_iso, torch.clamp(cos_t_hg, -1.0, 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    wo = Frame.from_normal(-wi).to_world(local)
    return wo, phase_eval(wi, wo, g)


# ---------------------------------------------------------------------------
# Rayleigh: p(cos) = 3 / (16 pi) (1 + cos^2)
# ---------------------------------------------------------------------------

def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has no cbrt): sign(x) |x|^(1/3).  XLA's cbrt
    may differ from it in the last bits."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def rayleigh_eval(wi: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    c = dot(-wi, wo)
    return 3.0 / (16.0 * math.pi) * (1.0 + c * c)


def rayleigh_sample(wi: torch.Tensor, u: torch.Tensor):
    """Exact inverse-CDF sampling of cos(theta): c^3/3 + c = (8u - 4)/3
    solved by Cardano, c = z - 1/z with z = (v + sqrt(v^2 + 1))^(1/3),
    v = 4u - 2.  Returns (wo, pdf)."""
    v = 2.0 * (2.0 * u[..., 0] - 1.0)
    z = _cbrt(v + torch.sqrt(v * v + 1.0))
    cos_t = torch.clamp(z - 1.0 / z, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    wo = Frame.from_normal(-wi).to_world(local)
    return wo, rayleigh_eval(wi, wo)


# ---------------------------------------------------------------------------
# Kajiya-Kay: a fiber phase with a diffuse floor and a cos^e specular cone
# about the mirrored polar angle, sampled uniformly over the sphere
# ---------------------------------------------------------------------------

def kkay_normalization(exponent: float) -> float:
    """1 / (2 pi int_0^pi sin^(e+1) theta dtheta), the normalisation for
    perpendicular illumination, in closed form by the Wallis integral."""
    e = float(exponent)
    integral = math.sqrt(math.pi) * math.gamma(e / 2 + 1.0) / math.gamma(e / 2 + 1.5)
    return 1.0 / (2.0 * math.pi * integral)


def kkay_eval(wi, wo, axis, aux):
    """aux = (ks, kd, exponent, normalisation); axis the fiber orientation."""
    ks, kd, e, norm = aux[0], aux[1], aux[2], aux[3]
    frame = Frame.from_normal(torch.broadcast_to(axis, wo.shape))
    rl = frame.to_local(wo)
    z = -dot(wi, torch.broadcast_to(axis, wi.shape))
    a = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0)
                   / torch.clamp_min(rl[..., 0] ** 2 + rl[..., 1] ** 2, 1e-12))
    R = frame.to_world(torch.stack([rl[..., 0] * a, rl[..., 1] * a, z], dim=-1))
    spec = torch.pow(torch.clamp_min(dot(R, wo), 0.0), e)
    return spec * norm * ks + kd * INV_FOURPI


def kkay_sample(wi, axis, aux, u):
    """Uniform-sphere proposal: (wo, pdf = 1/(4 pi), weight = eval 4 pi)."""
    wo = square_to_uniform_sphere(u)
    val = kkay_eval(wi, wo, axis, aux)
    return wo, torch.full(wo.shape[:-1], INV_FOURPI, device=wo.device), val * (4.0 * math.pi)


# ---------------------------------------------------------------------------
# Microflake fiber phase: specular flakes whose normals follow
# D(m) ~ exp(-cos^2 theta_m / (2 sigma^2)) about the fiber.
# eval = 0.5 D(h) / sigma_t(cos theta_wi); the sampler draws flake normals
# by truncated-Gaussian inversion and accepts with |wi.m| in _MF_K rounds.
# ---------------------------------------------------------------------------

_MF_K = 16  # rejection rounds


def microflake_tables(stddev: float, n: int = 64):
    """Host-side sigma_t table by quadrature: sigma_t(cos theta_w) =
    int |w.m| D(m) dm over n values of cos theta_w in [0, 1].  Returns
    (aux (4,), table (n,)) float32 numpy arrays; aux[3] is the
    direction-averaged sigma, the normaliser of the directional
    extinction in integrators/volpath.py."""
    s = float(stddev)
    norm = 1.0 / ((2.0 * math.pi) ** 1.5 * s * math.erf(1.0 / (math.sqrt(2.0) * s)))
    nt, np_ = 256, 64
    ct_m = np.linspace(-1.0, 1.0, nt)
    phi = np.linspace(0.0, 2.0 * np.pi, np_, endpoint=False)
    st_m = np.sqrt(np.maximum(1.0 - ct_m**2, 0.0))
    D = np.exp(-(ct_m**2) / (2 * s * s)) * norm
    ct_w = np.linspace(0.0, 1.0, n)
    st_w = np.sqrt(np.maximum(1.0 - ct_w**2, 0.0))
    dots = np.abs(
        ct_w[:, None, None] * ct_m[None, :, None]
        + st_w[:, None, None] * st_m[None, :, None] * np.cos(phi)[None, None, :]
    )
    sig = (dots.mean(-1) * D[None, :]).sum(-1) * (2.0 / nt) * (2.0 * np.pi)
    aux = np.array([s, norm, math.erf(1.0 / (math.sqrt(2.0) * s)), float(sig.mean())],
                   dtype=np.float32)
    return aux, sig.astype(np.float32)


def _mf_sigma_t(table, cos_w):
    n = table.shape[0]
    x = torch.abs(cos_w) * (n - 1)
    i0 = torch.clamp(torch.floor(x).to(torch.int64), 0, n - 2)
    f = x - i0
    return table[i0] * (1.0 - f) + table[i0 + 1] * f


def microflake_eval(wi, wo, axis, aux, table):
    s, norm = aux[0], aux[1]
    frame = Frame.from_normal(torch.broadcast_to(axis, wo.shape))
    wi_l = frame.to_local(wi)
    wo_l = frame.to_local(wo)
    h = wi_l + wo_l
    hl = torch.linalg.vector_norm(h, dim=-1)
    ct_h = torch.where(hl > 1e-9, h[..., 2] / torch.clamp_min(hl, 1e-9), 0.0)
    D = torch.exp(-ct_h * ct_h / (2.0 * s * s)) * norm
    sig = _mf_sigma_t(table, wi_l[..., 2])
    val = 0.5 * D / torch.clamp_min(sig, 1e-9)
    return torch.where(hl > 1e-9, val, 0.0)


_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))


def microflake_sample(wi, axis, aux, table, u):
    """_MF_K rounds of flake rejection; returns (wo, pdf = eval, weight,
    1 or 0 where every round rejected).  Each lane's rounds draw from
    their own stream: the two uniforms hash into a uint32 seed s (23 bits
    of each, the second shifted by 9), and the rounds take the 48 uniforms
    of the key (0, s), as ``jax.random.uniform(PRNGKey(s), (16, 3))``."""
    s, c1 = aux[0], aux[2]
    frame = Frame.from_normal(torch.broadcast_to(axis, wi.shape))
    wi_l = frame.to_local(wi)
    bits = (u * float(1 << 23)).to(torch.int64)
    seed = (bits[..., 0] ^ (bits[..., 1] << 9)) & rng.MASK32
    keys = torch.stack([torch.zeros_like(seed), seed], dim=-1)
    r = rng.uniform(keys, _MF_K * 3).reshape(u.shape[:-1] + (_MF_K, 3))
    u1, u2, u3 = r[..., 0], r[..., 1], r[..., 2]
    # truncated-Gaussian inversion of the flake's polar angle (XLA's
    # float32 erf_inv)
    ct = _SQRT2_F32 * s * _erfinv32(torch.clamp((2.0 * u1 - 1.0) * c1, -1.0 + 1e-7, 1.0 - 1e-7))
    ct = torch.clamp(ct, -1.0, 1.0)
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    ph = 2.0 * math.pi * u2
    m = torch.stack([st * torch.cos(ph), st * torch.sin(ph), ct], dim=-1)  # (..., K, 3)
    dp = torch.sum(wi_l[..., None, :] * m, dim=-1)
    accept = u3 < torch.abs(dp)
    # the first accepted round (argmax of the flags returns the first)
    idx = torch.argmax(accept.to(torch.int32), dim=-1)
    any_ok = torch.any(accept, dim=-1)
    m_sel = torch.take_along_dim(m, idx[..., None, None], dim=-2)[..., 0, :]
    dp_sel = torch.take_along_dim(dp, idx[..., None], dim=-1)[..., 0]
    wo_l = 2.0 * dp_sel[..., None] * m_sel - wi_l
    wo = frame.to_world(wo_l)
    pdf = microflake_eval(wi, wo, axis, aux, table)
    w = torch.where(any_ok, 1.0, 0.0)
    return wo, torch.where(any_ok, pdf, 0.0), w


# ---------------------------------------------------------------------------
# Mixture phase: a normalised weighted sum of HG (isotropic where |g| ~ 0)
# and Rayleigh components, as three parallel (K,) arrays.  Every component
# has eval == pdf, so the mixture's eval is its balance-heuristic pdf and
# its sample weight 1.
# ---------------------------------------------------------------------------

MIX_HG = 0
MIX_RAYLEIGH = 1


def _mix_component_pdf(cos_theta, gs, kinds):
    """(..., 1) cosines against (K,) components -> (..., K)."""
    hg = torch.where(torch.abs(gs) < 1e-4, INV_FOURPI, hg_pdf(cos_theta, gs))
    ray = 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)
    return torch.where(kinds == MIX_RAYLEIGH, ray, hg)


def mixture_eval(wi, wo, weights, gs, kinds):
    c = dot(-wi, wo)[..., None]
    return torch.sum(weights * _mix_component_pdf(c, gs, kinds), dim=-1)


def mixture_sample(wi, u, weights, gs, kinds):
    """A component by CDF inversion on u[..., 0], the uniform re-stretched
    inside its slab, that component's cos-CDF inverted; returns (wo, pdf)
    with the full balance sum as pdf."""
    cdf = torch.cumsum(weights, dim=0)
    u0 = u[..., 0]
    k = torch.sum((u0[..., None] >= cdf[:-1]).to(torch.int64), dim=-1)
    w_k = weights[k]
    lo = cdf[k] - w_k
    u0p = torch.clamp((u0 - lo) / torch.clamp_min(w_k, 1e-12), 0.0, 1.0 - 1e-7)
    g_k = torch.clamp(gs[k], -0.999, 0.999)
    sqr = (1.0 - g_k * g_k) / (1.0 - g_k + 2.0 * g_k * u0p)
    two_g = torch.where(torch.abs(g_k) < 1e-6, 1e-6, 2.0 * g_k)
    cos_hg = torch.where(torch.abs(g_k) < 1e-4, 1.0 - 2.0 * u0p,
                         torch.clamp((1.0 + g_k * g_k - sqr * sqr) / two_g, -1.0, 1.0))
    v = 2.0 * (2.0 * u0p - 1.0)
    z = _cbrt(v + torch.sqrt(v * v + 1.0))
    cos_ray = torch.clamp(z - 1.0 / z, -1.0, 1.0)
    cos_t = torch.where(kinds[k] == MIX_RAYLEIGH, cos_ray, cos_hg)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)
    wo = Frame.from_normal(-wi).to_world(local)
    return wo, mixture_eval(wi, wo, weights, gs, kinds)


# ---------------------------------------------------------------------------
# dispatch on the medium's host-side phase kind
# ---------------------------------------------------------------------------

def phase_eval_kind(wi, wo, g, kind: int = PhaseKind.HG, med=None):
    """The phase value of family ``kind``; ``med`` gives the fiber
    orientation and parameters (KKAY, MICROFLAKE) or the mixture."""
    if kind == PhaseKind.RAYLEIGH:
        return rayleigh_eval(wi, wo)
    if kind == PhaseKind.KKAY:
        return kkay_eval(wi, wo, med.orientation, med.phase_aux)
    if kind == PhaseKind.MICROFLAKE:
        return microflake_eval(wi, wo, med.orientation, med.phase_aux, med.sigt_table)
    if kind == PhaseKind.MIXTURE:
        return mixture_eval(wi, wo, med.mix_weights, med.mix_g, med.mix_kinds)
    return phase_eval(wi, wo, g)


def phase_sample_kind(wi, g, u, kind: int = PhaseKind.HG, med=None):
    """(wo, pdf); the weight of KKAY and MICROFLAKE is dropped (use
    phase_sample_kind_w)."""
    wo, pdf, _ = phase_sample_kind_w(wi, g, u, kind, med)
    return wo, pdf


def phase_sample_kind_w(wi, g, u, kind: int = PhaseKind.HG, med=None):
    """(wo, pdf, weight), weight = eval / pdf (1 for HG, Rayleigh and the
    mixture)."""
    if kind == PhaseKind.RAYLEIGH:
        wo, pdf = rayleigh_sample(wi, u)
        return wo, pdf, torch.ones_like(pdf)
    if kind == PhaseKind.KKAY:
        return kkay_sample(wi, med.orientation, med.phase_aux, u)
    if kind == PhaseKind.MICROFLAKE:
        return microflake_sample(wi, med.orientation, med.phase_aux, med.sigt_table, u)
    if kind == PhaseKind.MIXTURE:
        wo, pdf = mixture_sample(wi, u, med.mix_weights, med.mix_g, med.mix_kinds)
        return wo, pdf, torch.ones_like(pdf)
    wo, pdf = phase_sample(wi, g, u)
    return wo, pdf, torch.ones_like(pdf)
