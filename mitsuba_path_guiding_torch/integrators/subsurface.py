"""Dipole BSSRDF subsurface scattering and single scattering inside
refractive boundaries (port of the reference's integrators/subsurface.py).

The classical dipole (Jensen et al. 2001): irradiance samples on the
translucent surface and the diffusion kernel
  dMo = 1/(4 pi) (C1 e^{-str dr} / dr^2 + C2 e^{-str dv} / dv^2),
C1 = zr (str + 1/dr), C2 = zv (str + 1/dv), zr = 1/st', zv = zr (1 +
4A/3), A = (1 + Fdr) / (1 - Fdr), str = sqrt(3 sa st'), and Lo = (1 -
Fr(cos, eta)) Mo / pi.  The points are drawn area-weighted over the
tagged triangles on the host (numpy's ``default_rng(seed)``, as the
reference draws them), their irradiance is an NEE estimate, and Mo(x) is
a dense (pixels x samples) sweep in pixel chunks.  A scene's subsurface
rows are ``SceneData.sss_packed`` (S, 16) and each triangle's row is its
shading column 27 (``scene/builder.py`` ``_sss_row``).

Queries route as ``integrators.path.route_dense_or_bvh``: where the
reference's single scattering and camera hits take its dense oracle
(``intersect_brute``), the port takes the tiled kernel, whose winner is
the oracle's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.math import Frame, dot, fresnel_dielectric, refract_local
from mitsuba_path_guiding_torch.core.rng import event_uniform
from mitsuba_path_guiding_torch.integrators.irrcache import nee_sample
from mitsuba_path_guiding_torch.integrators.path import (
    INFD,
    _offset_ray,
    resolve_use_bvh,
    route_dense_or_bvh,
)
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.phase import phase_eval
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import SceneData


class SSSamples(NamedTuple):
    pos: torch.Tensor     # (S, 3)
    normal: torch.Tensor  # (S, 3)
    E: torch.Tensor       # (S, 3) irradiance
    area: torch.Tensor    # (S,) surface area a sample represents
    sid: torch.Tensor     # (S,) int32 sss row of the sample's triangle


def _fdr(eta):
    """fresnelDiffuseReflectance(1 / eta), d'Eon's fit: the dipole's
    boundary condition."""
    inv = 1.0 / eta
    return torch.where(
        inv < 1.0,
        -0.4399 + 0.7099 / inv - 0.3319 / (inv * inv) + 0.0636 / (inv * inv * inv),
        -1.4399 / (inv * inv) + 0.7099 / inv + 0.6681 + 0.0636 * inv,
    )


def sample_surface_points(scene: SceneData, n: int, seed: int = 0) -> SSSamples:
    """Area-weighted points on every subsurface triangle (the estimator
    needs the area coverage, not the points' separation)."""
    geo = scene.geo
    dev = geo.p0.device
    shade = geo.shade_packed.cpu().numpy()
    sid_tri = shade[:, 27].astype(np.int64)
    area = shade[:, 25]
    tri_ids = np.nonzero(sid_tri >= 0)[0]
    if tri_ids.size == 0:
        raise ValueError("scene has no subsurface-tagged shapes")
    w = area[tri_ids]
    rs = np.random.default_rng(seed)
    tri = tri_ids[rs.choice(tri_ids.size, size=n, p=w / w.sum())]
    # the triangle warp (core.warp.square_to_uniform_triangle) in numpy's
    # float32, whose square root is correctly rounded as the reference's
    # is (torch's on the CPU is not always)
    u = rs.random((n, 2)).astype(np.float32)
    su = np.sqrt(np.maximum(u[:, 0], np.float32(0.0)))
    b = torch.as_tensor(np.stack([np.float32(1.0) - su, u[:, 1] * su], axis=-1), device=dev)
    t = torch.as_tensor(tri, device=dev)
    p = geo.p0[t] + b[..., 0:1] * geo.e1[t] + b[..., 1:2] * geo.e2[t]
    row = gather_rows_t(geo.shade_packed, t.to(torch.int32))
    return SSSamples(pos=p, normal=torch.stack([row[0], row[1], row[2]], dim=-1),
                     E=torch.zeros((n, 3), dtype=torch.float32, device=dev),
                     area=torch.full((n,), float(w.sum()) / n, dtype=torch.float32, device=dev),
                     sid=torch.as_tensor(sid_tri[tri], dtype=torch.int32, device=dev))


def compute_irradiance(scene: SceneData, pts: SSSamples, cfg, n_nee: int = 8) -> SSSamples:
    """Direct irradiance at the sample points, ``n_nee`` NEE samples."""
    dev = pts.pos.device
    _, occluded = route_dense_or_bvh(scene, cfg.accel, resolve_use_bvh(scene, cfg))
    em_kinds = em_mod.kinds_present(scene.emitters)
    n = pts.pos.shape[0]
    key = rng.base_key(cfg.seed + 1234, device=dev)
    lanes = torch.arange(n, dtype=torch.int32, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s in range(n_nee):
        rk = rng.ray_keys(key, lanes, torch.full((n,), s, dtype=torch.int32, device=dev))
        ds, cos_r, ok = nee_sample(scene, occluded, pts.pos, pts.normal,
                                   event_uniform(rk, 13 << 20, 3), em_kinds)
        acc = acc + torch.where(
            ok[..., None], ds.radiance * (cos_r / torch.clamp_min(ds.pdf, 1e-12))[..., None], 0.0)
    return pts._replace(E=acc / n_nee)


def dipole_mo(sss_row, x, samples: SSSamples):
    """Mo(x) at query points x (N, 3) from every irradiance sample: the
    diffusion-kernel-weighted sum (the reference's
    IsotropicDipoleQuery).  Returns (N, 3)."""
    sa = sss_row[0:3] * sss_row[7]
    ssp = sss_row[3:6] * sss_row[7]
    stp = sa + ssp
    fdr = _fdr(sss_row[6])
    A = (1.0 + fdr) / torch.clamp_min(1.0 - fdr, 1e-6)
    sigma_tr = torch.sqrt(3.0 * sa * stp)
    zr = 1.0 / torch.clamp_min(stp, 1e-9)
    zv = zr * (1.0 + 4.0 / 3.0 * A)

    d2 = (torch.sum(x * x, dim=-1)[:, None]
          + torch.sum(samples.pos * samples.pos, dim=-1)[None, :]
          - 2.0 * (x @ samples.pos.T))
    d2 = torch.clamp_min(d2, 0.0)[..., None]  # (N, S, 1) over rgb
    dr = torch.sqrt(d2 + zr * zr)
    dv = torch.sqrt(d2 + zv * zv)
    c1 = zr * (sigma_tr + 1.0 / dr)
    c2 = zv * (sigma_tr + 1.0 / dv)
    dmo = (1.0 / (4.0 * math.pi)) * (c1 * torch.exp(-sigma_tr * dr) / (dr * dr)
                                     + c2 * torch.exp(-sigma_tr * dv) / (dv * dv))
    return (dmo * (samples.E * samples.area[:, None])[None]).sum(dim=1)


def render_subsurface(scene: SceneData, cfg, n_points: int = 2048, n_nee: int = 8,
                      chunk: int = 8192):
    """First camera hits on subsurface triangles return the dipole's Lo =
    (1 - Fr) Mo / pi (or ``singlescatter_lo`` for a single-scattering
    row); other surfaces get one NEE bounce and their visible emission.
    Returns (H, W, 3) on the scene's device."""
    if scene.sss_packed is None:
        raise ValueError("scene has no subsurface shapes")
    dev = scene.geo.p0.device
    use_bvh = resolve_use_bvh(scene, cfg)
    intersect, occluded = route_dense_or_bvh(scene, cfg.accel, use_bvh)
    em_kinds = em_mod.kinds_present(scene.emitters)
    mat_types = bsdf_mod.types_present(scene.mats)
    single = (scene.sss_packed[:, 9] >= 0.5).tolist()
    if not all(single):
        pts = compute_irradiance(scene, sample_surface_points(scene, n_points, seed=cfg.seed),
                                 cfg, n_nee=n_nee)

    w, h = cfg.width, cfg.height
    n_pix = w * h
    key = rng.base_key(cfg.seed, device=dev)
    pix = torch.arange(n_pix, dtype=torch.int32, device=dev)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    spp = max(cfg.spp, 1)
    for s in range(spp):
        rk = rng.ray_keys(key, pix, torch.full((n_pix,), s, dtype=torch.int32, device=dev))
        o, d, _ = generate_rays(scene.sensor, w, h, pix, event_uniform(rk, rng.TAG_CAMERA, 2),
                                kind=int(scene.sensor.kind))
        hit = intersect(o, d, None)
        p = o + torch.where(hit.valid, hit.t, 1.0)[..., None] * d
        row = gather_rows_t(scene.geo.shade_packed, torch.clamp_min(hit.prim, 0))
        ng = torch.stack([row[0], row[1], row[2]], dim=-1)
        sid = row[27].to(torch.int32)
        is_sss = hit.valid & (sid >= 0)
        # one subsurface row a pass keeps Mo's shapes fixed
        L = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
        for r in range(len(single)):
            sss_row = scene.sss_packed[r]
            mine = is_sss & (sid == r)
            if single[r]:
                lo = singlescatter_lo(scene, sss_row, r, p, d, ng, mine, rk, accel=cfg.accel,
                                      use_bvh=use_bvh)
            else:
                mo = torch.cat([dipole_mo(sss_row, p[i:i + chunk], pts)
                                for i in range(0, n_pix, chunk)], dim=0)
                ft = 1.0 - fresnel_dielectric(torch.abs(dot(ng, -d)), sss_row[6])
                lo = mo / math.pi * ft[..., None]
            L = torch.where(mine[..., None], lo, L)
        # other surfaces: one NEE bounce
        ds, cos_x, ok = nee_sample(scene, occluded, p, ng, event_uniform(rk, 7 << 20, 3),
                                   em_kinds)
        alb = bsdf_mod.albedo(scene.mats, row[18].to(torch.int32), types=mat_types)
        l_dir = torch.where(
            (hit.valid & ~is_sss & ok)[..., None],
            alb / math.pi * ds.radiance * (cos_x / torch.clamp_min(ds.pdf, 1e-12))[..., None],
            0.0)
        # visible emission
        Le = torch.where(((row[19] >= 0.0) & (dot(ng, -d) > 0.0) & hit.valid)[..., None],
                         torch.stack([row[20], row[21], row[22]], dim=-1), 0.0)
        acc = acc + L + l_dir + Le
    return (acc / float(spp)).reshape(h, w, 3)


def singlescatter_lo(scene: SceneData, sss_row, sid_row: int, p, d, ng, valid, rk,
                     use_bvh: bool = False, n_dist: int = 4, accel: str = "auto"):
    """Single scattering inside a refractive boundary (the reference's
    singlescatter): exact refraction and Fresnel at the entry point, then
    ``n_dist`` stratified truncated-exponential distances along the
    internal ray, each with a light connection that crosses the boundary
    in a straight line (internal attenuation to the exit point, the exit's
    Fresnel transmittance, occlusion outside).  First-order scattering
    only.  ``use_bvh`` and ``accel`` route as ``route_dense_or_bvh``."""
    geo, em = scene.geo, scene.emitters
    intersect, occluded = route_dense_or_bvh(scene, accel, use_bvh)
    em_kinds = em_mod.kinds_present(em)

    scale = sss_row[7]
    sa = sss_row[0:3] * scale
    ss_c = sss_row[3:6] * scale
    st = sa + ss_c
    eta = sss_row[6]
    g = sss_row[8]

    frame = Frame.from_normal(ng)
    wi_l = frame.to_local(-d)
    wt_l, tir = refract_local(wi_l, eta)
    d_in = frame.to_world(wt_l)
    fr_in = fresnel_dielectric(wi_l[..., 2], eta)
    enter = valid & ~tir

    o_in = p - ng * 1e-4
    hx = intersect(o_in, d_in, None)
    t_exit = torch.where(hx.valid, hx.t, 1e-3)
    st_bar = torch.clamp_min(torch.mean(st), 1e-9)

    acc = torch.zeros((p.shape[0], 3), dtype=torch.float32, device=p.device)
    for k in range(n_dist):
        u = event_uniform(rk, (17 << 20) + k, 4)
        uk = (k + u[..., 0]) / n_dist
        cdf_end = -torch.expm1(-st_bar * t_exit)
        t_k = -torch.log1p(-uk * cdf_end) / st_bar
        t_k = torch.minimum(t_k, t_exit * (1.0 - 1e-4))
        pdf_k = st_bar * torch.exp(-st_bar * t_k) / torch.clamp_min(cdf_end, 1e-12)
        x = o_in + t_k[..., None] * d_in

        ds = em_mod.sample_direct(em, geo, x, u[..., 1:4], kinds=em_kinds)
        hb = intersect(x, ds.direction, None)
        row_b = gather_rows_t(geo.shade_packed, torch.clamp_min(hb.prim, 0))
        same = hb.valid & (row_b[27].to(torch.int32) == sid_row)
        t_b = torch.where(same, hb.t, 0.0)
        ng_b = torch.stack([row_b[0], row_b[1], row_b[2]], dim=-1)
        # the exit's Fresnel from inside (a negative cosine flips eta)
        cos_b = torch.abs(dot(ng_b, ds.direction))
        ft_out = torch.where(same, 1.0 - fresnel_dielectric(-cos_b, eta), 1.0)
        exit_p = x + t_b[..., None] * ds.direction
        rem = torch.where(ds.distance >= INFD, INFD,
                          torch.clamp_min(ds.distance - t_b, 0.0) * (1.0 - 1e-3))
        occ = occluded(_offset_ray(exit_p, ng_b, ds.direction), ds.direction, rem)
        ph = phase_eval(-d_in, ds.direction, g)
        tr = torch.exp(-st[None, :] * (t_k + t_b)[..., None])
        w = ss_c[None, :] * tr * (ph / torch.clamp_min(ds.pdf * pdf_k, 1e-20))[..., None]
        good = enter & ~occ & (ds.pdf > 0.0) & (ft_out > 0.0)
        acc = acc + torch.where(good[..., None],
                                ((1.0 - fr_in) * ft_out)[..., None] * ds.radiance * w, 0.0)
    return acc / n_dist
