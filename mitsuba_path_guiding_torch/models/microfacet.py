"""GGX microfacet distribution with Smith shadowing and visible-normal
sampling, and Beckmann's D and G1 (port of the reference's
models/microfacet.py).

Directions are in the local shading frame (+z = normal).
"""
from __future__ import annotations

import math

import torch

from mitsuba_path_guiding_torch.core.math import (abs_cos_theta, cos_theta, cross, dot, normalize,
                                                   safe_sqrt)

ALPHA_MIN = 1e-4


def ggx_d(m: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """GGX NDF D(m), isotropic."""
    a2 = alpha * alpha
    c2 = torch.clamp_min(cos_theta(m), 0.0) ** 2
    denom = math.pi * (c2 * (a2 - 1.0) + 1.0) ** 2
    return torch.where(cos_theta(m) > 0.0, a2 / torch.clamp_min(denom, 1e-20), 0.0)


def ggx_lambda(w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Smith Lambda of GGX."""
    c = cos_theta(w)
    c2 = c * c
    t2 = torch.clamp_min(1.0 - c2, 0.0) / torch.clamp_min(c2, 1e-12)
    return 0.5 * (torch.sqrt(1.0 + alpha * alpha * t2) - 1.0)


def ggx_g1(w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + ggx_lambda(w, alpha))


def ggx_g2(wi: torch.Tensor, wo: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Height-correlated Smith G2."""
    return 1.0 / (1.0 + ggx_lambda(wi, alpha) + ggx_lambda(wo, alpha))


def ggx_sample_vndf(wi: torch.Tensor, alpha: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Sample the GGX visible normals (Heitz 2018); ``wi`` in the upper
    hemisphere."""
    vh = normalize(torch.stack([alpha * wi[..., 0], alpha * wi[..., 1], wi[..., 2]], dim=-1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / torch.sqrt(torch.clamp_min(lensq, 1e-20))
    t1 = torch.where(
        (lensq > 1e-14)[..., None],
        torch.stack([-vh[..., 1] * inv, vh[..., 0] * inv, torch.zeros_like(inv)], dim=-1),
        torch.tensor([1.0, 0.0, 0.0], dtype=vh.dtype, device=vh.device).expand(vh.shape),
    )
    t2 = cross(vh, t1)
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    return normalize(torch.stack(
        [alpha * nh[..., 0], alpha * nh[..., 1], torch.clamp_min(nh[..., 2], 1e-6)], dim=-1))


def ggx_vndf_pdf(wi: torch.Tensor, m: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """pdf of ggx_sample_vndf in the half-vector measure:
    G1(wi) D(m) max(0, wi.m) / cos_theta(wi)."""
    ci = torch.clamp_min(cos_theta(wi), 1e-6)
    return ggx_g1(wi, alpha) * ggx_d(m, alpha) * torch.clamp_min(dot(wi, m), 0.0) / ci


def beckmann_d(m: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Beckmann NDF D(m), isotropic."""
    a2 = alpha * alpha
    c = cos_theta(m)
    c2 = torch.clamp_min(c * c, 1e-12)
    t2 = (1.0 - c2) / c2
    return torch.where(c > 0.0,
                       torch.exp(-t2 / a2) / torch.clamp_min(math.pi * a2 * c2 * c2, 1e-20), 0.0)


def beckmann_g1(w: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Smith G1 of Beckmann, Walter et al.'s rational fit."""
    c = abs_cos_theta(w)
    t = safe_sqrt(1.0 - c * c) / torch.clamp_min(c, 1e-12)
    a = 1.0 / torch.clamp_min(alpha * t, 1e-12)
    poly = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return torch.where(a < 1.6, poly, 1.0)
