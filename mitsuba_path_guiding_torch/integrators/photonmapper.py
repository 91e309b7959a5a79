"""Classic photon mapping with a final gather (port of the reference's
integrators/photonmapper.py, Jensen 1996).

The global and caustic maps share ``integrators.sppm``'s sorted grid: the
caustic map is the deposits ``sppm.photon_pass`` flags all-specular.  One
photon wave serves every camera pass, and each map is sorted once a
render (the reference sorts anew at each gather, to the same order).
Each camera sample's hitpoint x (the first non-delta vertex) gets
  L(x) = Le(chain) + L_direct (NEE) + L_caustic (caustic-map density)
       + L_indirect (a cosine gather ray -> the global map's density at y),
the gather ray giving nothing where it escapes or hits an emitter (both
are direct light at x, counted by NEE).  The densities evaluate the
diffuse lobe (albedo / pi).  Queries route as
``integrators.path.route_dense_or_bvh``.
"""
from __future__ import annotations

import math

import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.core.math import Frame, dot
from mitsuba_path_guiding_torch.core.rng import event_uniform
from mitsuba_path_guiding_torch.core.warp import square_to_cosine_hemisphere
from mitsuba_path_guiding_torch.integrators.path import INFD, _offset_ray, route_dense_or_bvh
from mitsuba_path_guiding_torch.integrators.ptracer import live_tmax
from mitsuba_path_guiding_torch.integrators.sppm import (
    SortedPhotons,
    camera_pass,
    gather_sorted,
    grid_params,
    photon_pass,
    scene_extent,
    sort_photons,
)
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import SceneData

TAG_NEE = 11 << 20
TAG_GATHER = 12 << 20


def sum_bins(phi):
    """(N, 3) sum of the direction bins (N, K, 3), bin by bin in order."""
    acc = phi[:, 0]
    for k in range(1, phi.shape[1]):
        acc = acc + phi[:, k]
    return acc


def _shade_pass(scene: SceneData, rkeys, hp, global_map: SortedPhotons,
                caustic_map: SortedPhotons, lo, inv_cell: float, G: int, r_global, r_caustic,
                n_emitted: int, accel: str = "auto", em_kinds=em_mod.PORTED_KINDS,
                mat_types=bsdf_mod.PORTED_TYPES):
    """The radiance of the hitpoints ``hp`` (``sppm.Hitpoints``) past their
    chain's emission: hp.T (L_direct + L_caustic + L_indirect).
    ``r_global`` and ``r_caustic`` are float32 0-d tensors."""
    geo, em = scene.geo, scene.emitters
    n = hp.pos.shape[0]
    intersect, occluded = route_dense_or_bvh(scene, accel)

    # direct light at x by NEE (the diffuse lobe)
    ds = em_mod.sample_direct(em, geo, hp.pos, event_uniform(rkeys, TAG_NEE, 3), kinds=em_kinds)
    cos_x = torch.clamp_min(dot(hp.ns, ds.direction), 0.0)
    t_sh = torch.where(ds.distance >= INFD, INFD, ds.distance * (1.0 - 1e-3))
    live = hp.valid & (ds.pdf > 0)
    occ = occluded(_offset_ray(hp.pos, hp.ns, ds.direction), ds.direction, live_tmax(t_sh, live))
    f_d = hp.alb / math.pi * cos_x[..., None]
    L_dir = torch.where((live & ~occ)[..., None],
                        f_d * ds.radiance / torch.clamp_min(ds.pdf, 1e-12)[..., None], 0.0)

    # caustics from the caustic map at x (the bins summed: the diffuse
    # estimate)
    _, phi_c_bins, _ = gather_sorted(caustic_map, hp.pos, hp.ns, r_caustic.expand(n), lo,
                                     inv_cell, G)
    phi_c = sum_bins(phi_c_bins)
    L_cau = torch.where(hp.valid[..., None],
                        hp.alb / math.pi * phi_c / (math.pi * r_caustic * r_caustic * n_emitted),
                        0.0)

    # one final-gather bounce, the global map's estimate at y
    u_g = event_uniform(rkeys, TAG_GATHER, 2)
    d_g = Frame.from_normal(hp.ns).to_world(square_to_cosine_hemisphere(u_g))
    o_g = _offset_ray(hp.pos, hp.ns, d_g)
    hit = intersect(o_g, d_g, live_tmax(INFD, hp.valid))
    y = o_g + torch.where(hit.valid, hit.t, 1.0)[..., None] * d_g
    row = gather_rows_t(geo.shade_packed, torch.clamp_min(hit.prim, 0))
    ng_y = torch.stack([row[0], row[1], row[2]], dim=-1)
    ns_y = torch.where(dot(ng_y, -d_g)[..., None] < 0.0, -ng_y, ng_y)
    alb_y = bsdf_mod.albedo(scene.mats, row[18].to(torch.int32), types=mat_types)
    is_emitter_y = row[19] >= 0.0
    _, phi_y_bins, _ = gather_sorted(global_map, y, ns_y, r_global.expand(n), lo, inv_cell, G)
    phi_y = sum_bins(phi_y_bins)
    L_y = alb_y / math.pi * phi_y / (math.pi * r_global * r_global * n_emitted)
    # the cosine pdf cancels f cos of the diffuse lobe: albedo x L_y
    ok_g = hp.valid & hit.valid & ~is_emitter_y
    L_ind = torch.where(ok_g[..., None], hp.alb * L_y, 0.0)
    return hp.T * (L_dir + L_cau + L_ind)


def photon_maps(scene: SceneData, cfg, n_photons: int, cell: float, em_kinds, mat_types):
    """The render's photon wave, sorted twice: (global map, caustic map,
    lo, 1 / cell, G)."""
    dev = scene.geo.p0.device
    lo, inv_cell, G = grid_params(scene, cell)
    ids = torch.arange(n_photons, dtype=torch.int32, device=dev) + (1 << 24)
    rk = rng.ray_keys(rng.base_key(cfg.seed, device=dev), ids, torch.zeros_like(ids))
    pos, wi, pw, ok, caustic = photon_pass(scene, rk, max_depth=cfg.max_depth, accel=cfg.accel,
                                           em_kinds=em_kinds, mat_types=mat_types)
    return (sort_photons(pos, wi, pw, ok, lo, inv_cell, G),
            sort_photons(pos, wi, pw, ok & caustic, lo, inv_cell, G), lo, inv_cell, G)


def render_photonmapper(scene: SceneData, cfg, n_photons: int = 1 << 17,
                        r_global: float | None = None, r_caustic: float | None = None):
    """Classic photon-mapping render: cfg.spp camera samples a pixel, each
    with one final-gather ray.  Returns (H, W, 3) on the scene's device."""
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    dev = resolve_device(scene.geo.p0.device)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    em_kinds = kinds_present(scene.emitters)
    mat_types = types_present(scene.mats)
    extent = scene_extent(scene)
    if r_global is None:
        r_global = 0.025 * extent
    if r_caustic is None:
        r_caustic = 0.012 * extent
    # one photon map for every camera pass (classic photon mapping is
    # consistent in the photons, not in spp)
    global_map, caustic_map, lo, inv_cell, G = photon_maps(
        scene, cfg, n_photons, 2.0 * max(r_global, r_caustic), em_kinds, mat_types)
    r_g = torch.tensor(r_global, dtype=torch.float32, device=dev)
    r_c = torch.tensor(r_caustic, dtype=torch.float32, device=dev)
    key = rng.base_key(cfg.seed, device=dev)
    pix = torch.arange(n_pix, dtype=torch.int32, device=dev)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    kw = dict(accel=cfg.accel, em_kinds=em_kinds, mat_types=mat_types)
    spp = max(cfg.spp, 1)
    for s in range(spp):
        rk = rng.ray_keys(key, pix, torch.full_like(pix, s))
        hp = camera_pass(scene, rk, w, h, event_uniform(rk, 1 << 20, 2), pix,
                         max_depth=cfg.max_depth, sensor_kind=int(scene.sensor.kind), **kw)
        acc = acc + hp.L + _shade_pass(scene, rk, hp, global_map, caustic_map, lo, inv_cell, G,
                                       r_g, r_c, n_photons, **kw)
    return (acc / float(spp)).reshape(h, w, 3)
