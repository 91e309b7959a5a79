"""Vector math and shading frames (port of the reference's core/math.py).

Vectors are ``(..., 3)`` float32 tensors.  Dot products are written out
component by component (((x0 y0 + x1 y1) + x2 y2)) so that the CPU and the
card sum in the same order as the CUDA kernels do.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

EPS = 1e-6
INF = math.inf


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Safe normalize; zero vectors map to zero."""
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), 1e-30))[..., None]


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp_min(x, 0.0))


def lerp(a, b, t):
    return a + (b - a) * t


def safe_rcp(x: torch.Tensor) -> torch.Tensor:
    """Signed reciprocal clamped to +-1e20."""
    sign = torch.where(x >= 0.0, 1.0, -1.0)
    return sign / torch.clamp_min(torch.abs(x), 1e-20)


class Frame(NamedTuple):
    """Orthonormal shading frame: ``n`` is the z-axis."""

    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor

    @staticmethod
    def from_normal(n: torch.Tensor) -> "Frame":
        """Duff et al. branchless ONB construction."""
        sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
        a = -1.0 / (sign + n[..., 2])
        b = n[..., 0] * n[..., 1] * a
        s = torch.stack(
            [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
            dim=-1,
        )
        t = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
        return Frame(s=s, t=t, n=n)

    def to_local(self, v: torch.Tensor) -> torch.Tensor:
        return torch.stack([dot(v, self.s), dot(v, self.t), dot(v, self.n)], dim=-1)

    def to_world(self, v: torch.Tensor) -> torch.Tensor:
        return v[..., 0:1] * self.s + v[..., 1:2] * self.t + v[..., 2:3] * self.n


def cos_theta(v):
    return v[..., 2]


def abs_cos_theta(v):
    return torch.abs(v[..., 2])


def sin_theta2(v):
    return torch.clamp_min(1.0 - v[..., 2] * v[..., 2], 0.0)


def sin_theta(v):
    return safe_sqrt(sin_theta2(v))


def tan_theta(v):
    return sin_theta(v) / torch.where(torch.abs(v[..., 2]) < 1e-12, 1e-12, v[..., 2])


def tan_theta2(v):
    c2 = v[..., 2] * v[..., 2]
    return sin_theta2(v) / torch.clamp_min(c2, 1e-20)


def sphdir(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Spherical (theta from +z, phi about z) to cartesian."""
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)


def reflect_local(wi: torch.Tensor) -> torch.Tensor:
    """Specular reflection in the local frame (negate x, y)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def reflect(w: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Reflect the direction ``w`` (pointing away from the surface) about
    the normal ``n``."""
    return 2.0 * dot(w, n)[..., None] * n - w


def refract_local(wi: torch.Tensor, eta: torch.Tensor):
    """Refraction in the local frame; ``eta`` the interior/exterior IOR
    ratio.  Returns (wt, total internal reflection mask)."""
    rel_eta = torch.where(cos_theta(wi) > 0.0, eta, 1.0 / eta)
    c2 = 1.0 - (1.0 - wi[..., 2] * wi[..., 2]) / (rel_eta * rel_eta)
    tir = c2 <= 0.0
    ct_t = safe_sqrt(c2) * -torch.sign(wi[..., 2])
    scale = -1.0 / rel_eta
    wt = torch.stack([wi[..., 0] * scale, wi[..., 1] * scale, ct_t], dim=-1)
    return wt, tir


def fresnel_dielectric(cos_i: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Unpolarised Fresnel reflectance of a dielectric interface (the
    reference's fresnelDielectricExt); 1 under total internal reflection."""
    rel_eta = torch.where(cos_i > 0.0, eta, 1.0 / eta)
    ci = torch.abs(cos_i)
    st2 = torch.clamp_min(1.0 - ci * ci, 0.0) / (rel_eta * rel_eta)
    tir = st2 >= 1.0
    ct = safe_sqrt(1.0 - st2)
    r_s = (ci - rel_eta * ct) / torch.clamp_min(ci + rel_eta * ct, 1e-12)
    r_p = (rel_eta * ci - ct) / torch.clamp_min(rel_eta * ci + ct, 1e-12)
    f = 0.5 * (r_s * r_s + r_p * r_p)
    return torch.where(tir, 1.0, f)


def fresnel_conductor(cos_i: torch.Tensor, eta: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Unpolarised conductor Fresnel per channel (the reference's
    fresnelConductorExact form).  cos_i (...,), eta/k (..., 3) -> (..., 3)."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2, k2 = eta * eta, k * k
    t0 = eta2 - k2 - si2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * eta2 * k2)
    t1 = a2b2 + ci2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp_min(t1 + t2, 1e-12)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp_min(t3 + t4, 1e-12)
    return 0.5 * (rp + rs)


def face_forward(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Flip n so that it lies in the hemisphere of d."""
    return torch.where(dot(n, d)[..., None] < 0.0, -n, n)


def spherical_phi_theta(d: torch.Tensor):
    """Cartesian -> (phi in [0, 2 pi), theta in [0, pi])."""
    theta = torch.arccos(torch.clamp(d[..., 2], -1.0, 1.0))
    phi = torch.atan2(d[..., 1], d[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    return phi, theta


def power_heuristic(pdf_a: torch.Tensor, pdf_b: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2) MIS weight for strategy a."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-30)
    return torch.where(pdf_a > 0.0, w, 0.0)


def scatter_add_rows(acc: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """acc[idx[i]] += rows[i] in place, in an order fixed by the data: on
    the CPU ``index_add_`` adds the rows serially, in row order; on the
    card its float atomics would add rows that share an index in whatever
    order the threads arrive, so the card takes ``index_put_``'s
    accumulation, which groups the rows by index with a stable sort and
    adds each index's rows in turn."""
    if acc.is_cuda:
        return acc.index_put_((idx,), rows, accumulate=True)
    return acc.index_add_(0, idx, rows)
