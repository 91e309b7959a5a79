"""Irradiance caching meta-integrator (port of the reference's
integrators/irrcache.py).

An overture pass drops records at a sqrt(n) x sqrt(n) grid of camera
first hits (``sppm.camera_pass``) and estimates each record's indirect
irradiance in one wavefront: M x N cosine-stratified cells (bands sin^2
theta = j / M, sectors 2 pi k / N) of S rays each, traced by the path
tracer, minus an NEE estimate of the direct irradiance.  R_i is the
harmonic mean of the gather rays' hit distances, and the cells' radiance
and distances give the Ward-Heckbert translational and rotational
gradients (``_wh_gradients``).  A pixel interpolates the records with
Ward's weights w_i = 1 / (|x - x_i| / R_i + sqrt(1 - n . n_i)), each
record extrapolated by its gradients, as (N, R) @ (R, 3) matrix products
(``torch.matmul``; PyTorch's default keeps TF32 off on the card); the
distance is |p|^2 + |x_i|^2 - 2 p . x_i, as the reference writes it.  A
pixel with no usable record takes the nearest valid one.  Direct light
stays exact per pixel.

Queries route as ``integrators.path.route_dense_or_bvh`` (the tiled
kernel up to BRUTE_FORCE_MAX_TRIS triangles, else the BVH; the reference's
``use_bvh`` is ``RenderConfig.accel`` here), the gather rays' paths
through ``trace`` on the same route.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.math import Frame, dot
from mitsuba_path_guiding_torch.core.rng import event_uniform
from mitsuba_path_guiding_torch.integrators.path import (
    INFD,
    _offset_ray,
    dense_or_bvh_accel,
    route_dense_or_bvh,
    trace,
)
from mitsuba_path_guiding_torch.integrators.sppm import camera_pass
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.scene.types import SceneData


class IrradianceCache(NamedTuple):
    pos: torch.Tensor     # (R, 3)
    normal: torch.Tensor  # (R, 3)
    E: torch.Tensor       # (R, 3) indirect irradiance
    R_harm: torch.Tensor  # (R,) harmonic mean gather distance
    valid: torch.Tensor   # (R,) bool
    grad_t: torch.Tensor  # (R, 3, 3) translational gradient [axis, channel]
    grad_r: torch.Tensor  # (R, 3, 3) rotational gradient [axis, channel]


def _phi_dirs(phi, tangent: bool):
    """(N, 3) unit vectors at azimuths ``phi``: the tangent (-sin, cos, 0)
    or the radial (cos, sin, 0) direction."""
    z = torch.zeros_like(phi)
    if tangent:
        return torch.stack([-torch.sin(phi), torch.cos(phi), z], dim=-1)
    return torch.stack([torch.cos(phi), torch.sin(phi), z], dim=-1)


def _wh_gradients(L, r, M: int, N: int):
    """Ward-Heckbert cell-wall gradients of the stratified gather.

    ``L`` (R, M, N, 3) per-cell radiance, ``r`` (R, M, N) hit distances
    (INFD: the wall contributes nothing).  Returns (grad_t, grad_r), each
    (R, 3, 3) [local-frame axis, channel]; the caller rotates the axes to
    world space."""
    dev = L.device
    j = torch.arange(M, dtype=torch.float32, device=dev)
    k = torch.arange(N, dtype=torch.float32, device=dev)
    # cell centres
    s2c = (j + 0.5) / M
    ct_c = torch.sqrt(1.0 - s2c)
    tan_c = torch.sqrt(s2c) / torch.clamp_min(ct_c, 1e-4)
    phi_c = 2.0 * math.pi * (k + 0.5) / N
    # boundaries
    st_lo = torch.sqrt(j / M)  # sin(theta_{j-})
    ct_lo = torch.sqrt(1.0 - j / M)
    st_hi = torch.sqrt((j + 1.0) / M)
    phi_lo = 2.0 * math.pi * k / N

    inv_r = torch.where(r >= INFD, 0.0, 1.0 / torch.clamp_min(r, 1e-4))

    # rotational: (pi / (M N)) sum tan(theta_j) L_jk phihat_k
    wrot = (math.pi / (M * N)) * tan_c[None, :, None, None] * L
    grad_r = torch.einsum("rmnc,na->rac", wrot, _phi_dirs(phi_c, True))

    # translational, theta walls (j vs j - 1) along uhat_k, over the
    # smaller of the two cells' distances (the larger inverse)
    dL_t = L[:, 1:] - L[:, :-1]
    minv_t = torch.maximum(inv_r[:, 1:], inv_r[:, :-1])
    coef_t = (2.0 * math.pi / N) * (st_lo * ct_lo * ct_lo)[1:]
    wall_t = coef_t[None, :, None, None] * minv_t[..., None] * dL_t
    grad_t = torch.einsum("rmnc,na->rac", wall_t, _phi_dirs(phi_c, False))

    # translational, phi walls (k vs k - 1, wrapping) along phihat at the
    # boundary azimuth; a band's wall integral is sin(theta_{j+}) -
    # sin(theta_{j-})
    dL_p = L - torch.roll(L, 1, dims=2)
    minv_p = torch.maximum(inv_r, torch.roll(inv_r, 1, dims=2))
    coef_p = st_hi - st_lo
    wall_p = coef_p[None, :, None, None] * minv_p[..., None] * dL_p
    grad_t = grad_t + torch.einsum("rmnc,na->rac", wall_p, _phi_dirs(phi_lo, True))
    return grad_t, grad_r


def nee_sample(scene, occluded, p, n, u, em_kinds):
    """One NEE sample at each lane of points ``p`` with normals ``n``,
    its shadow ray through the route's ``occluded``: (the sample, the
    cosine at the lane, visible: unoccluded with a positive pdf)."""
    ds = em_mod.sample_direct(scene.emitters, scene.geo, p, u, kinds=em_kinds)
    cos_r = torch.clamp_min(dot(n, ds.direction), 0.0)
    t_sh = torch.where(ds.distance >= INFD, INFD, ds.distance * (1.0 - 1e-3))
    occ = occluded(_offset_ray(p, n, ds.direction), ds.direction, t_sh)
    return ds, cos_r, ~occ & (ds.pdf > 0)


def build_irradiance_cache(scene: SceneData, cfg, n_records: int = 1024,
                           rays_per_record: int = 64) -> IrradianceCache:
    """Overture pass: records at a sqrt(n) x sqrt(n) camera grid."""
    dev = scene.geo.p0.device
    accel = dense_or_bvh_accel(scene, cfg.accel)
    _, occluded = route_dense_or_bvh(scene, cfg.accel)
    em_kinds = em_mod.kinds_present(scene.emitters)
    mat_types = bsdf_mod.types_present(scene.mats)

    res = int(np.ceil(np.sqrt(n_records)))
    n_rec = res * res
    pix = torch.arange(n_rec, dtype=torch.int32, device=dev)
    key = rng.base_key(cfg.seed + 77, device=dev)
    rk = rng.ray_keys(key, pix, torch.zeros_like(pix))
    u_pos = event_uniform(rk, 1 << 20, 2)
    hp = camera_pass(scene, rk, res, res, u_pos, pix, max_depth=cfg.max_depth, accel=accel,
                     em_kinds=em_kinds, mat_types=mat_types,
                     sensor_kind=int(scene.sensor.kind))
    hp_pos, hp_ns, hp_valid = hp.pos, hp.ns, hp.valid

    # M x N cosine-stratified cells of S rays each in one wave; the grid is
    # capped at 4 x 16 cells so that each cell averages >= S samples
    cells_target = min(rays_per_record, 64)
    Mb = max(int(round(np.sqrt(cells_target / 4.0))), 1)
    Nb = max(cells_target // Mb, 1)
    S = max(rays_per_record // (Mb * Nb), 1)
    K = Mb * Nb * S
    rpos = torch.repeat_interleave(hp_pos, K, dim=0)
    rns = torch.repeat_interleave(hp_ns, K, dim=0)
    lane = torch.arange(n_rec * K, dtype=torch.int32, device=dev)
    rk_g = rng.ray_keys(key, lane + (1 << 22), torch.zeros_like(lane))
    u_g = event_uniform(rk_g, 3 << 20, 2)
    cell_id = (lane % K) // S
    jj = (cell_id // Nb).to(torch.float32)
    kk = (cell_id % Nb).to(torch.float32)
    s2 = (jj + u_g[..., 0]) / Mb  # sin^2 theta (cosine-stratified)
    st = torch.sqrt(s2)
    ct = torch.sqrt(1.0 - s2)
    phi = 2.0 * math.pi * (kk + u_g[..., 1]) / Nb
    d_loc = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
    d_g = Frame.from_normal(rns).to_world(d_loc)
    o_g = _offset_ray(rpos, rns, d_g)
    # the camera and gather segments used 2 of the path budget
    L, aux, _ = trace(scene, o_g, d_g, rk_g, max_depth=max(cfg.max_depth - 2, 1),
                      rr_depth=cfg.rr_depth, use_nee=True, em_kinds=em_kinds,
                      mat_types=mat_types, accel=accel)
    # the cosine-weighted pdf cancels the cosine: E_full = pi mean(L)
    E_full = math.pi * L.reshape(n_rec, K, 3).mean(dim=1)
    # harmonic mean distance of the gather hits (misses count nothing)
    t_hit = aux.depth_t.reshape(n_rec, K)
    hit_ok = (t_hit > 0.0) & (t_hit < INFD)
    inv_sum = torch.sum(torch.where(hit_ok, 1.0 / torch.clamp_min(t_hit, 1e-6), 0.0), dim=1)
    n_hit = torch.clamp_min(torch.sum(hit_ok, dim=1), 1)
    R_harm = torch.where(inv_sum > 0, n_hit / torch.clamp_min(inv_sum, 1e-9), 1e6)

    # the gradients of the cells' indirect radiance: emission seen at the
    # first gather hit is the direct irradiance, which E excludes
    L_ind = L - aux.first_le
    L_cell = L_ind.reshape(n_rec, Mb, Nb, S, 3).mean(dim=3)
    t_c = t_hit.reshape(n_rec, Mb, Nb, S)
    fin = (t_c > 0.0) & (t_c < INFD)  # depth_t stays 0 on a full miss
    inv_c = torch.sum(torch.where(fin, 1.0 / torch.clamp_min(t_c, 1e-6), 0.0), dim=3)
    cnt_c = torch.sum(fin, dim=3)
    r_cell = torch.where(inv_c > 0, cnt_c / torch.clamp_min(inv_c, 1e-9), INFD)
    gt_loc, gr_loc = _wh_gradients(L_cell, r_cell, Mb, Nb)
    hframe = Frame.from_normal(hp_ns)
    grad_t = torch.stack([hframe.to_world(gt_loc[:, :, c]) for c in range(3)], dim=-1)
    grad_r = torch.stack([hframe.to_world(gr_loc[:, :, c]) for c in range(3)], dim=-1)

    # direct irradiance from M NEE samples: E_ind = E_full - E_dir
    M = 32
    dpos = torch.repeat_interleave(hp_pos, M, dim=0)
    dns = torch.repeat_interleave(hp_ns, M, dim=0)
    lane_d = torch.arange(n_rec * M, dtype=torch.int32, device=dev)
    rk_d = rng.ray_keys(key, lane_d + (1 << 23), torch.zeros_like(lane_d))
    ds, cos_r, vis = nee_sample(scene, occluded, dpos, dns, event_uniform(rk_d, 5 << 20, 3),
                                em_kinds)
    e_d = torch.where(vis[..., None],
                      ds.radiance * (cos_r / torch.clamp_min(ds.pdf, 1e-12))[..., None], 0.0)
    E_dir = e_d.reshape(n_rec, M, 3).mean(dim=1)

    E_ind = torch.clamp_min(E_full - E_dir, 0.0)
    return IrradianceCache(pos=hp_pos, normal=hp_ns, E=E_ind, R_harm=R_harm, valid=hp_valid,
                           grad_t=grad_t, grad_r=grad_r)


def _interp_chunk(cache: IrradianceCache, p, ns, max_error: float = 0.25,
                  use_gradients: bool = True):
    """Ward-weighted interpolation as (N, R) @ (R, 3) products.  With
    gradients each record extrapolates E_i + (p - x_i) . gradT_i + (n_i x
    n) . gradR_i; p and n factor out of the weighted sum, so the
    extrapolation is 7 more such products."""
    d2 = (torch.sum(p * p, dim=-1)[:, None]
          + torch.sum(cache.pos * cache.pos, dim=-1)[None, :]
          - 2.0 * (p @ cache.pos.T))
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    ndot = torch.clamp(ns @ cache.normal.T, -1.0, 1.0)
    w = 1.0 / (d / torch.clamp_min(cache.R_harm[None, :], 1e-6)
               + torch.sqrt(torch.clamp_min(1.0 - ndot, 0.0)) + 1e-6)
    w = torch.where(cache.valid[None, :] & (w > 1.0 / max_error), w, 0.0)
    wsum = w.sum(dim=1)
    if use_gradients:
        # translational: sum_i w_i (p - x_i) . Gt_i
        #   = sum_d p_d (w @ Gt[:, d]) - w @ (sum_d x_d Gt[:, d])
        A = torch.einsum("rd,rdc->rc", cache.pos, cache.grad_t)
        acc = w @ (cache.E - A)
        for dd in range(3):
            acc = acc + p[:, dd:dd + 1] * (w @ cache.grad_t[:, dd, :])
        # rotational: (n_i x n) . Gr_i = sum_b n_b D_i[b]
        ni, Gr = cache.normal, cache.grad_r
        D = (ni[:, 2:3] * Gr[:, 1, :] - ni[:, 1:2] * Gr[:, 2, :],
             ni[:, 0:1] * Gr[:, 2, :] - ni[:, 2:3] * Gr[:, 0, :],
             ni[:, 1:2] * Gr[:, 0, :] - ni[:, 0:1] * Gr[:, 1, :])
        for b in range(3):
            acc = acc + ns[:, b:b + 1] * (w @ D[b])
        E = acc / torch.clamp_min(wsum, 1e-9)[..., None]
        E = torch.clamp_min(E, 0.0)  # extrapolation may undershoot
    else:
        E = (w @ cache.E) / torch.clamp_min(wsum, 1e-9)[..., None]
    # no usable record: the nearest valid one (the reference would insert
    # a record; a static wavefront reuses the closest)
    d_v = torch.where(cache.valid[None, :], d, torch.inf)
    nearest = torch.argmin(d_v, dim=1)
    return torch.where((wsum > 0)[..., None], E, cache.E[nearest])


def interpolate_irradiance(cache: IrradianceCache, p, ns, max_error: float = 0.25,
                           chunk: int = 16384, use_gradients: bool = True):
    """Pixel chunks keep the (N, R) working set bounded."""
    return torch.cat([_interp_chunk(cache, p[i:i + chunk], ns[i:i + chunk], max_error,
                                    use_gradients)
                      for i in range(0, p.shape[0], chunk)], dim=0)


def render_irrcache(scene: SceneData, cfg, n_records: int = 1024, rays_per_record: int = 64,
                    max_error: float = 0.25, cache: IrradianceCache | None = None,
                    use_gradients: bool = True):
    """Exact emission + NEE direct + interpolated indirect irradiance on
    the diffuse lobe.  Returns (H, W, 3) on the scene's device."""
    dev = scene.geo.p0.device
    w, h = cfg.width, cfg.height
    n_pix = w * h
    accel = dense_or_bvh_accel(scene, cfg.accel)
    _, occluded = route_dense_or_bvh(scene, cfg.accel)
    em_kinds = em_mod.kinds_present(scene.emitters)
    mat_types = bsdf_mod.types_present(scene.mats)
    if cache is None:
        cache = build_irradiance_cache(scene, cfg, n_records, rays_per_record)

    key = rng.base_key(cfg.seed, device=dev)
    pix = torch.arange(n_pix, dtype=torch.int32, device=dev)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    spp = max(cfg.spp, 1)
    for s in range(spp):
        rk = rng.ray_keys(key, pix, torch.full((n_pix,), s, dtype=torch.int32, device=dev))
        u_pos = event_uniform(rk, 1 << 20, 2)
        hp = camera_pass(scene, rk, w, h, u_pos, pix, max_depth=cfg.max_depth, accel=accel,
                         em_kinds=em_kinds, mat_types=mat_types,
                         sensor_kind=int(scene.sensor.kind))
        ds, cos_x, vis = nee_sample(scene, occluded, hp.pos, hp.ns,
                                    event_uniform(rk, 9 << 20, 3), em_kinds)
        L_dir = torch.where(
            (hp.valid & vis)[..., None],
            hp.alb / math.pi * ds.radiance * (cos_x / torch.clamp_min(ds.pdf, 1e-12))[..., None],
            0.0)
        E = interpolate_irradiance(cache, hp.pos, hp.ns, max_error, use_gradients=use_gradients)
        L_ind = torch.where(hp.valid[..., None], hp.alb / math.pi * E, 0.0)
        acc = acc + hp.L + hp.T * (L_dir + L_ind)
    return (acc / float(spp)).reshape(h, w, 3)
