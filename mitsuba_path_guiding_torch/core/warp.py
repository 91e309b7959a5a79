"""Sample warping, unit square -> disks/spheres/triangles (port of the
reference's core/warp.py)."""
from __future__ import annotations

import math

import torch

from mitsuba_path_guiding_torch.core.math import safe_sqrt

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
INV_FOURPI = 1.0 / (4.0 * math.pi)


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_sphere_pdf(d):
    return torch.full(d.shape[:-1], INV_FOURPI, device=d.device)


def square_to_uniform_hemisphere(u):
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_hemisphere_pdf(d):
    return torch.where(d[..., 2] >= 0.0, INV_TWOPI, 0.0)


def square_to_uniform_disk_concentric(u):
    """Shirley-Chiu concentric disk mapping."""
    x = 2.0 * u[..., 0] - 1.0
    y = 2.0 * u[..., 1] - 1.0
    zero = (x == 0.0) & (y == 0.0)
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)

    def safe(a, b):
        return a / torch.where(torch.abs(b) < 1e-12, 1.0, b)

    phi = torch.where(
        use_x,
        (math.pi / 4.0) * safe(y, x),
        (math.pi / 2.0) - (math.pi / 4.0) * safe(x, y),
    )
    r = torch.where(zero, 0.0, r)
    phi = torch.where(zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def square_to_uniform_disk_pdf(p):
    return torch.full(p.shape[:-1], INV_PI, device=p.device)


def square_to_cosine_hemisphere(u):
    """Malley's method via the concentric disk."""
    p = square_to_uniform_disk_concentric(u)
    z = safe_sqrt(1.0 - p[..., 0] ** 2 - p[..., 1] ** 2)
    return torch.stack([p[..., 0], p[..., 1], z], dim=-1)


def square_to_cosine_hemisphere_pdf(d):
    return torch.clamp_min(d[..., 2], 0.0) * INV_PI


def square_to_uniform_cone(u, cos_cutoff):
    """Uniform on the spherical cap cos(theta) in [cos_cutoff, 1]."""
    z = 1.0 - u[..., 0] * (1.0 - cos_cutoff)
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def square_to_uniform_cone_pdf(d, cos_cutoff):
    inside = d[..., 2] >= cos_cutoff
    span = torch.as_tensor(1.0 - cos_cutoff, dtype=d.dtype, device=d.device)
    return torch.where(inside, INV_TWOPI / torch.clamp_min(span, 1e-12), 0.0)


def square_to_uniform_triangle(u):
    """Barycentric coords uniform on the unit triangle."""
    su = safe_sqrt(u[..., 0])
    return torch.stack([1.0 - su, u[..., 1] * su], dim=-1)


def square_to_std_normal(u):
    """Box-Muller transform to a 2D standard normal."""
    r = safe_sqrt(-2.0 * torch.log(torch.clamp_min(1.0 - u[..., 0], 1e-20)))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)


def interval_to_tent(u):
    """[0, 1) -> [-1, 1], tent-distributed (the monotone inverse CDF)."""
    return torch.where(u < 0.5, safe_sqrt(2.0 * u) - 1.0,
                       1.0 - safe_sqrt(torch.clamp_min(2.0 - 2.0 * u, 0.0)))
