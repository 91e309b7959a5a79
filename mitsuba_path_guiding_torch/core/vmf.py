"""von Mises-Fisher distribution on S^2: pdf, sample and moment fit (port
of the reference's core/vmf.py)."""
from __future__ import annotations

import math

import torch

from mitsuba_path_guiding_torch.core.math import Frame, dot, normalize, safe_sqrt
from mitsuba_path_guiding_torch.core.warp import INV_FOURPI

KAPPA_MAX = 1e4
KAPPA_MIN = 1e-3


def vmf_pdf(d: torch.Tensor, mu: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
    """kappa / (2 pi (1 - e^{-2 kappa})) * e^{kappa (d.mu - 1)}."""
    t = dot(d, mu)
    k = torch.clamp(kappa, 0.0, KAPPA_MAX)
    denom = 2.0 * math.pi * -torch.expm1(-2.0 * k)
    norm = torch.where(k > 1e-6, k / torch.clamp_min(denom, 1e-30), INV_FOURPI)
    return norm * torch.exp(k * (torch.clamp(t, -1.0, 1.0) - 1.0))


def vmf_sample(u: torch.Tensor, mu: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF sampling: w = 1 + log(u + (1-u) e^{-2 kappa}) / kappa."""
    k = torch.clamp(kappa, 0.0, KAPPA_MAX)
    u0 = torch.clamp(u[..., 0], 1e-7, 1.0 - 1e-7)
    safe_k = torch.clamp_min(k, KAPPA_MIN)
    w = 1.0 + torch.log(u0 + (1.0 - u0) * torch.exp(-2.0 * safe_k)) / safe_k
    w = torch.where(k > KAPPA_MIN, w, 1.0 - 2.0 * u0)
    w = torch.clamp(w, -1.0, 1.0)
    r = safe_sqrt(1.0 - w * w)
    phi = 2.0 * math.pi * u[..., 1]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), w], dim=-1)
    return Frame.from_normal(mu).to_world(local)


def mean_cosine_to_kappa(r: torch.Tensor) -> torch.Tensor:
    """Banerjee et al.: kappa ~= r(3 - r^2)/(1 - r^2), clamped."""
    r = torch.clamp(r, 0.0, 0.9999)
    kappa = r * (3.0 - r * r) / torch.clamp_min(1.0 - r * r, 1e-6)
    return torch.clamp(kappa, 0.0, KAPPA_MAX)


def kappa_to_mean_cosine(kappa: torch.Tensor) -> torch.Tensor:
    """coth(kappa) - 1/kappa, the vMF mean resultant length (kappa / 3 for
    small kappa)."""
    k = torch.clamp_min(kappa, 1e-4)
    return torch.where(kappa > 1e-3, 1.0 / torch.tanh(k) - 1.0 / k, kappa / 3.0)


def vmf_fit_from_moments(weighted_dir_sum: torch.Tensor, weight_sum: torch.Tensor):
    """(mu, kappa) from the sufficient statistics sum(w d), sum(w)."""
    norm = torch.linalg.norm(weighted_dir_sum, dim=-1)
    r = norm / torch.clamp_min(weight_sum, 1e-12)
    mu = weighted_dir_sum / torch.clamp_min(norm, 1e-12)[..., None]
    bad = (weight_sum <= 1e-12) | (norm <= 1e-12)
    up = torch.tensor([0.0, 0.0, 1.0], device=mu.device)
    mu = torch.where(bad[..., None], up, mu)
    kappa = torch.where(bad, 0.0, mean_cosine_to_kappa(r))
    return normalize(mu), kappa


def vmf_product_kappa_mu(mu_a, kappa_a, mu_b, kappa_b):
    """The unnormalised product of two vMFs is a vMF: kappa* mu* = ka mu_a
    + kb mu_b.  Returns (mu*, kappa*)."""
    v = kappa_a[..., None] * mu_a + kappa_b[..., None] * mu_b
    kappa = torch.linalg.norm(v, dim=-1)
    mu = v / torch.clamp_min(kappa, 1e-12)[..., None]
    return mu, kappa
