"""Henyey-Greenstein phase function (port of the reference's
models/phase.py ``hg_pdf``, ``phase_eval`` and ``phase_sample``: the
pieces the HK slab BSDF calls).

Convention of the reference: ``wi`` points toward the previous vertex,
``wo`` away from the collision; g > 0 scatters forward, i.e. the pdf
peaks at wo ~ -wi (cos(theta) = dot(-wi, wo)).  HG is sampled exactly
(eval == pdf, weight 1).  Rayleigh, Kajiya-Kay, microflake and the
mixtures come with volumes (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import math

import torch

from mitsuba_path_guiding_torch.core.math import Frame, dot
from mitsuba_path_guiding_torch.core.warp import INV_FOURPI


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
