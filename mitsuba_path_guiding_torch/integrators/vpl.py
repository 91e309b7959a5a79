"""Instant-radiosity VPL renderer (port of the reference's integrators/vpl.py
``VPLs``, ``generate_vpls`` and ``render_vpl``).

A light pass deposits virtual point lights along emitter random walks;
the camera pass shades every first-hit pixel against every VPL, with
``clamp_dist`` flooring the connection distance (relative to the scene's
diagonal) as instant radiosity does: VPL images are biased by
construction.

The reference unrolls ``vpl_chunk`` (128) VPLs a call, each one
full-image shadow query.  Here a chunk of C VPLs is one query of C x N
lanes (VPL-major), C chosen so a chunk holds about ``CHUNK_LANES`` lanes
(a power of two up to ``vpl_chunk``, a multiple of it above).  The
contributions add in the reference's order: VPL by VPL into a sum that
restarts every ``vpl_chunk`` VPLs, each block's sum then added to the
image (torch's cumsum would not do: on the CPU it adds float32 in
float64).  Queries route as
``integrators.path.route_dense_or_bvh``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_path_guiding_torch.core.math import Frame, dot
from mitsuba_path_guiding_torch.core.rng import TAG_CAMERA, bounce_uniform, event_uniform
from mitsuba_path_guiding_torch.integrators.path import (
    INFD,
    _offset_ray,
    resolve_use_bvh,
    route_dense_or_bvh,
)
from mitsuba_path_guiding_torch.integrators.ptracer import TAG_EMITTER_RAY, _decode_hit, live_tmax
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene.types import SceneData

CHUNK_LANES = 1 << 21  # (VPL, pixel) lanes of one shading chunk


class VPLs(NamedTuple):
    pos: torch.Tensor     # (V, 3)
    normal: torch.Tensor  # (V, 3) shading normal (0 for point emitters)
    wi: torch.Tensor      # (V, 3) incident direction, toward the previous vertex
    flux: torch.Tensor    # (V, 3) particle power, or the emitted weight
    mid: torch.Tensor     # (V,) material row; -1 an emission VPL
    valid: torch.Tensor   # (V,) bool


def generate_vpls(scene: SceneData, n_paths: int, seed: int = 0, max_depth: int = 3,
                  use_bvh: bool = False, accel: str = "auto", em_kinds=em_mod.PORTED_KINDS,
                  mat_types=bsdf_mod.PORTED_TYPES) -> VPLs:
    """Deterministic VPL random walks: one emission VPL and up to
    max_depth surface VPLs a path, depth-major (V = (max_depth + 1) *
    n_paths)."""
    from mitsuba_path_guiding_torch.core import rng

    geo, mats, em = scene.geo, scene.mats, scene.emitters
    dev = geo.p0.device
    intersect, _ = route_dense_or_bvh(scene, accel, use_bvh)
    pid = torch.arange(n_paths, dtype=torch.int64, device=dev)
    lkeys = rng.ray_keys(rng.base_key(seed, device=dev), pid, torch.zeros_like(pid))

    rs = em_mod.sample_ray(em, scene.aabb_min, scene.aabb_max,
                           event_uniform(lkeys, TAG_EMITTER_RAY, 5), kinds=em_kinds)
    # emission VPLs: direct light from the emitter surface itself
    verts = [(rs.o, rs.normal, torch.zeros_like(rs.o),
              torch.where(rs.valid[..., None], rs.emit_weight, 0.0),
              torch.full((n_paths,), -1, dtype=torch.int32, device=dev),
              rs.valid & (torch.amax(rs.emit_weight, dim=-1) > 0.0))]
    o, d = rs.o, rs.d
    T = torch.where(rs.valid[..., None], rs.weight, 0.0)
    alive = rs.valid
    for depth in range(max_depth):
        u = bounce_uniform(lkeys, depth, 9)
        hit = intersect(o, d, torch.where(alive, INFD, -1.0))
        act = alive & hit.valid
        p, ng, ns, row, _ = _decode_hit(geo, hit, o, d)
        mid = row[18].to(torch.int32)
        frame = Frame.from_normal(ns)
        wi_local = frame.to_local(-d)
        verts.append((p, ns, -d, torch.where(act[..., None], T, 0.0), mid, act))
        bs = bsdf_mod.sample(mats, mid, wi_local, u[..., 3:6], types=mat_types)
        wo_world = frame.to_world(bs.wo)
        T_new = T * bs.weight
        cont = act & (bs.pdf > 0.0) & (torch.amax(torch.abs(T_new), dim=-1) > 0.0)
        o = torch.where(cont[..., None], _offset_ray(p, ng, wo_world), o)
        d = torch.where(cont[..., None], wo_world, d)
        T = torch.where(cont[..., None], T_new, T)
        alive = cont
    return VPLs(*(torch.cat(f, dim=0) for f in zip(*verts)))


class CameraHits(NamedTuple):
    """A camera pass's first hits, one a pixel."""

    valid: torch.Tensor  # (N,)
    p: torch.Tensor      # (N, 3)
    ng: torch.Tensor     # (N, 3)
    ns: torch.Tensor     # (N, 3)
    mid: torch.Tensor    # (N,)
    wi: torch.Tensor     # (N, 3) toward the camera
    le: torch.Tensor     # (N, 3) emission seen at the hit


def camera_pass(scene: SceneData, cfg, intersect, sidx) -> CameraHits:
    """The first hits of sample ``sidx`` of every pixel."""
    from mitsuba_path_guiding_torch.core import rng

    dev = scene.geo.p0.device
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int64, device=dev)
    rkeys = rng.ray_keys(rng.base_key(cfg.seed, device=dev), pix, torch.full_like(pix, sidx))
    o, d, _ = generate_rays(scene.sensor, cfg.width, cfg.height, pix,
                            event_uniform(rkeys, TAG_CAMERA, 2))
    hit = intersect(o, d, None)
    p, ng, ns, row, _ = _decode_hit(scene.geo, hit, o, d)
    cos_l = dot(ng, -d)
    le = torch.where(((row[19] >= 0.0) & (cos_l > 0.0) & hit.valid)[..., None],
                     torch.stack([row[20], row[21], row[22]], dim=-1), 0.0)
    return CameraHits(hit.valid, p, ng, ns, row[18].to(torch.int32), -d, le)


def chunk_shadow_rays(cam: CameraHits, vpl_pos, d_min2):
    """The (C * N)-lane fan of a chunk of C VPLs over N camera hits,
    VPL-major: (origin, direction, distance, clamped 1 / d^2)."""
    c, n = vpl_pos.shape[0], cam.p.shape[0]
    p = cam.p.repeat(c, 1)
    seg = vpl_pos.repeat_interleave(n, dim=0) - p
    d2 = torch.clamp_min(dot(seg, seg), 1e-12)
    dist = torch.sqrt(d2)
    dir_pv = seg / dist[..., None]
    g = 1.0 / torch.clamp_min(d2, d_min2)
    return _offset_ray(p, cam.ng.repeat(c, 1), dir_pv), dir_pv, dist, g


def shade_chunk(scene: SceneData, cam: CameraHits, vpls: VPLs, occluded, d_min2, mat_types):
    """(C, N, 3): each of the chunk's C VPLs' contribution to the N camera
    hits (one any-hit query of C * N lanes)."""
    mats = scene.mats
    c, n = vpls.pos.shape[0], cam.p.shape[0]
    o_sh, dir_pv, dist, g = chunk_shadow_rays(cam, vpls.pos, d_min2)
    ns = cam.ns.repeat(c, 1)
    frame = Frame.from_normal(ns)
    mid = cam.mid.repeat(c)
    f_cam, _ = bsdf_mod.eval_pdf(mats, mid, frame.to_local(cam.wi.repeat(c, 1)),
                                 frame.to_local(dir_pv), types=mat_types)
    # the VPL's response: an emission VPL radiates its weight times cos
    vn = vpls.normal.repeat_interleave(n, dim=0)
    vmid = vpls.mid.repeat_interleave(n)
    cos_v = torch.abs(dot(vn, -dir_pv))
    vframe = Frame.from_normal(vn)
    f_vpl, _ = bsdf_mod.eval_pdf(mats, torch.clamp_min(vmid, 0),
                                 vframe.to_local(vpls.wi.repeat_interleave(n, dim=0)),
                                 vframe.to_local(-dir_pv), types=mat_types)
    resp = torch.where((vmid < 0)[..., None], cos_v[..., None], f_vpl)
    ok = cam.valid.repeat(c) & vpls.valid.repeat_interleave(n)
    occ = occluded(o_sh, dir_pv, live_tmax(dist * (1.0 - 2e-3), ok))
    contrib = f_cam * resp * vpls.flux.repeat_interleave(n, dim=0) * g[..., None]
    return torch.where((ok & ~occ)[..., None], contrib, 0.0).reshape(c, n, 3)


def _chunk_size(n_vpl: int, n_pix: int, block: int) -> int:
    """VPLs a chunk: about CHUNK_LANES / n_pix, a power of two up to
    ``block`` and a multiple of it above."""
    c = max(1, CHUNK_LANES // n_pix)
    c = (c // block) * block if c >= block else 1 << (c.bit_length() - 1)
    return min(c, n_vpl)


def _ordered_sum(acc, block_acc, contrib, c0: int, n_vpl: int, block: int):
    """Add VPLs c0.. (contrib (C, N, 3)) in the reference's order: each
    into its block's running sum, a finished block's sum into acc."""
    a = c0
    while a < c0 + contrib.shape[0]:
        b = min((a // block + 1) * block, c0 + contrib.shape[0])
        for k in range(a - c0, b - c0):
            block_acc = block_acc + contrib[k]
        if b % block == 0 or b == n_vpl:
            acc = acc + block_acc
            block_acc = torch.zeros_like(block_acc)
        a = b
    return acc, block_acc


def render_vpl(scene: SceneData, cfg, n_vpl_paths: int = 256, clamp_dist: float = 0.1,
               vpl_chunk: int = 128):
    """VPL render: the first camera hits shaded against every VPL.
    ``vpl_chunk`` is the reference's chunk (the order of the sums).
    Returns (H, W, 3) on the scene's device."""
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    w, h = cfg.width, cfg.height
    n_pix = w * h
    dev = scene.geo.p0.device
    em_kinds = kinds_present(scene.emitters)
    mat_types = types_present(scene.mats)
    use_bvh = resolve_use_bvh(scene, cfg)
    intersect, occluded = route_dense_or_bvh(scene, cfg.accel, use_bvh)
    diag = float(torch.linalg.vector_norm(scene.aabb_max - scene.aabb_min))
    d_min = clamp_dist * diag
    vpls = generate_vpls(scene, n_vpl_paths, seed=cfg.seed + 1,
                         max_depth=max(cfg.max_depth - 2, 1), use_bvh=use_bvh, accel=cfg.accel,
                         em_kinds=em_kinds, mat_types=mat_types)
    n_vpl = int(vpls.pos.shape[0])
    chunk = _chunk_size(n_vpl, n_pix, vpl_chunk)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    acc_le = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    spp = max(cfg.spp, 1)
    for s in range(spp):
        cam = camera_pass(scene, cfg, intersect, s)
        acc_le = acc_le + cam.le  # a camera sample's, not a VPL path's
        block_acc = torch.zeros_like(acc)
        for c0 in range(0, n_vpl, chunk):
            part = VPLs(*(f[c0:c0 + chunk] for f in vpls))
            acc, block_acc = _ordered_sum(
                acc, block_acc, shade_chunk(scene, cam, part, occluded, d_min * d_min, mat_types),
                c0, n_vpl, vpl_chunk)
    img = acc / float(spp * n_vpl_paths) + acc_le / float(spp)
    return img.reshape(h, w, 3)
