"""Specular manifold walks (port of the reference's
integrators/manifold.py; Mitsuba's libbidir manifold.cpp).

One specular vertex z on a triangle, barycentrics (u, v), between
endpoints x and y:
  wi = normalize(x - z), wo = normalize(y - z)
  H  = eta_x wi + eta_y wo
  c(u, v) = (H_hat . t1(z), H_hat . t2(z)) = 0
with (t1, t2) the tangent frame of the interpolated shading normal;
eta_x = eta_y gives mirror reflection, unequal etas Snell refraction.
The Newton walk runs over a whole batch of connections; its 2x2 Jacobian
columns are ``torch.func.jvp`` directional derivatives (the reference's
``jax.jvp``, with the same tangents), and each proposal is re-projected
onto the surface by the caller's ``intersect_fn(o, d) -> Hit``, which
stays outside the jvp closures (on the card the tiled kernel).
``generalized_geometry`` gives |d omega_x / dA_y| of a converged chain by
the implicit-function theorem, again from jvps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp

from mitsuba_path_guiding_torch.core.math import dot, normalize

EPS_T = 1e-4


def _onb(n):
    """Branchless orthonormal basis (Frisvad/Duff)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t1 = torch.stack([1.0 + s * n[..., 0] * n[..., 0] * a, s * b, -s * n[..., 0]], dim=-1)
    t2 = torch.stack([b, s + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t1, t2


def _tri_rows(geo, prim):
    w = prim.to(torch.int64)
    rows = geo.shade_packed[w]
    return geo.p0[w], geo.e1[w], geo.e2[w], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]


def _vertex(geo, prim, u, v):
    p0, e1, e2, n0, n1, n2 = _tri_rows(geo, prim)
    z = p0 + u[:, None] * e1 + v[:, None] * e2
    ns = normalize((1.0 - u - v)[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2)
    return z, ns


def _constraint(geo, prim, u, v, x, y, eta_x, eta_y):
    """(c1, c2): the tangent-plane components of the generalized half
    vector."""
    z, ns = _vertex(geo, prim, u, v)
    t1, t2 = _onb(ns)
    wi = normalize(x - z)
    wo = normalize(y - z)
    h = normalize(eta_x[:, None] * wi + eta_y[:, None] * wo)
    return dot(h, t1), dot(h, t2)


class WalkResult(NamedTuple):
    prim: torch.Tensor       # (N,) int32 final triangle
    u: torch.Tensor          # (N,)
    v: torch.Tensor          # (N,)
    z: torch.Tensor          # (N, 3) final vertex
    normal: torch.Tensor     # (N, 3) shading normal at z
    converged: torch.Tensor  # (N,) bool
    residual: torch.Tensor   # (N,) |c| at the end


def _uv_jacobian(fn, u, v):
    """fn(u, v) and its two jvp columns: ((f1, f2), (df/du), (df/dv))."""
    ones, zeros = torch.ones_like(u), torch.zeros_like(u)
    val, du = jvp(fn, (u, v), (ones, zeros))
    _, dv = jvp(fn, (u, v), (zeros, ones))
    return val, du, dv


def specular_manifold_walk(geo, intersect_fn, x, y, prim0, u0, v0, eta_x, eta_y,
                           n_iters: int = 12, step_clamp: float = 0.5,
                           tol: float = 1e-4) -> WalkResult:
    """Batched Newton walk of one specular vertex (chain length 1).

    ``intersect_fn(o, d) -> Hit`` re-projects proposals onto the surface
    (crossing triangle boundaries); a ray whose proposal escapes keeps its
    vertex.  Convergence is judged by the final constraint residual."""
    prim, u, v = prim0, u0, v0
    for _ in range(n_iters):
        def c_uv(uu, vv, prim=prim):
            return _constraint(geo, prim, uu, vv, x, y, eta_x, eta_y)

        (c1, c2), (a, c_), (b, d_) = _uv_jacobian(c_uv, u, v)
        det = a * d_ - b * c_
        safe = torch.abs(det) > 1e-18
        inv = torch.where(safe, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
        du = (-c1 * d_ + c2 * b) * inv
        dv = (-c2 * a + c1 * c_) * inv
        # clamp the barycentric step (trust region)
        mag = torch.sqrt(du * du + dv * dv)
        sc = torch.where(mag > step_clamp, step_clamp / torch.clamp_min(mag, 1e-12), 1.0)
        u_n = u + du * sc
        v_n = v + dv * sc

        # re-project through the scene: trace x -> proposal
        p0, e1, e2, *_ = _tri_rows(geo, prim)
        z_prop = p0 + u_n[:, None] * e1 + v_n[:, None] * e2
        d_dir = normalize(z_prop - x)
        hit = intersect_fn(x + d_dir * EPS_T, d_dir)
        ok = hit.valid & safe
        prim = torch.where(ok, hit.prim, prim)
        u = torch.where(ok, hit.u, u)
        v = torch.where(ok, hit.v, v)
    c1, c2 = _constraint(geo, prim, u, v, x, y, eta_x, eta_y)
    res = torch.sqrt(c1 * c1 + c2 * c2)
    z, ns = _vertex(geo, prim, u, v)
    return WalkResult(prim=prim, u=u, v=v, z=z, normal=ns, converged=res < tol, residual=res)


def generalized_geometry(geo, wr: WalkResult, x, y, light_n, eta_x, eta_y):
    """|d omega_x / dA_y| of the converged chain (the manifold replacement
    of NEE's cos(theta_y) / r^2), by the implicit-function theorem:
      duv/dy = -J_uv^{-1} J_y,  domega/dy = J_omega_uv duv/dy,
      density = |det of domega/dy in a frame normal to omega|.
    Returns (density, omega)."""
    prim, u, v = wr.prim, wr.u, wr.v

    def c_of_uv(uu, vv):
        return _constraint(geo, prim, uu, vv, x, y, eta_x, eta_y)

    _, (a, c_), (b, d_) = _uv_jacobian(c_of_uv, u, v)
    ty1, ty2 = _onb(light_n)

    def c_of_y(yv):
        return _constraint(geo, prim, u, v, x, yv, eta_x, eta_y)

    _, (e1c, e2c) = jvp(c_of_y, (y,), (ty1,))
    _, (f1c, f2c) = jvp(c_of_y, (y,), (ty2,))

    det_uv = a * d_ - b * c_
    inv = 1.0 / torch.where(torch.abs(det_uv) < 1e-18, 1.0, det_uv)
    # duv/dy columns: the k-th column is -J_uv^{-1} [dc/dy_k]
    du_dy1 = -(d_ * e1c - b * e2c) * inv
    dv_dy1 = -(-c_ * e1c + a * e2c) * inv
    du_dy2 = -(d_ * f1c - b * f2c) * inv
    dv_dy2 = -(-c_ * f1c + a * f2c) * inv

    def omega(uu, vv):
        p0, e1, e2, *_ = _tri_rows(geo, prim)
        z = p0 + uu[:, None] * e1 + vv[:, None] * e2
        return normalize(z - x)

    w, dw_du, dw_dv = _uv_jacobian(omega, u, v)
    dw_dy1 = dw_du * du_dy1[:, None] + dw_dv * dv_dy1[:, None]
    dw_dy2 = dw_du * du_dy2[:, None] + dw_dv * dv_dy2[:, None]

    b1, b2 = _onb(w)
    m11 = dot(b1, dw_dy1)
    m12 = dot(b1, dw_dy2)
    m21 = dot(b2, dw_dy1)
    m22 = dot(b2, dw_dy2)
    dens = torch.abs(m11 * m22 - m12 * m21)
    return torch.where(torch.abs(det_uv) < 1e-18, 0.0, dens), w


def fresnel_transmittance(cos_i, eta_rel):
    """Unpolarized Fresnel transmittance entering a medium of relative IOR
    ``eta_rel`` (Mitsuba's fresnelDielectricExt)."""
    ci = torch.abs(cos_i)
    sin2_t = (1.0 - ci * ci) / (eta_rel * eta_rel)
    tir = sin2_t >= 1.0
    ct = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    rs = (ci - eta_rel * ct) / (ci + eta_rel * ct)
    rp = (eta_rel * ci - ct) / (eta_rel * ci + ct)
    r = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 0.0, 1.0 - r)
