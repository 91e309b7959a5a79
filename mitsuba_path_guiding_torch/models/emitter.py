"""Emitter sampling (port of the reference's models/emitter.py:
``kinds_present``, ``_pick_emitter``, ``sample_direct`` for the AREA,
POINT, SPOT, CONSTANT, DIRECTIONAL and ENVMAP kinds, ``eval_hit`` and
``pdf_direct_hit``, ``eval_env`` / ``pdf_env``, which give zero when the
scene has no environment light, and the emitter-ray sampler
``sample_ray`` of the light-path integrators).  A COLLIMATED emitter
radiates along one ray: its NEE sample carries no radiance, as in the
reference.

``sample_direct(..., vcm=True)`` also returns the bidirectional MIS
extras ``cos_light`` and ``emission_pdf_w`` (BDPT's s=1 strategy); the
path tracers leave them out and run none of their ops.  Infinite
emitters emit from a disk facing the scene, of the bounding sphere's
radius ``scene_radius`` (0.5 |aabb_max - aabb_min| + 1e-3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

import math

from mitsuba_path_guiding_torch.core.math import Frame, cross, dot, normalize
from mitsuba_path_guiding_torch.core.warp import (
    INV_FOURPI,
    square_to_cosine_hemisphere,
    square_to_uniform_disk_concentric,
    square_to_uniform_sphere,
    square_to_uniform_triangle,
)
from mitsuba_path_guiding_torch.models.envmap import env_eval, env_pdf_dir, env_sample
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import EmitterKind, Emitters, Geometry

INFD = 3.0e37
K = EmitterKind
PORTED_KINDS = (K.AREA, K.POINT, K.CONSTANT, K.DIRECTIONAL, K.SPOT, K.ENVMAP, K.COLLIMATED)


class DirectSample(NamedTuple):
    """One NEE sample toward an emitter, from shading point ``p``."""

    direction: torch.Tensor  # (N, 3) unit, from p toward the emitter
    distance: torch.Tensor   # (N,)
    radiance: torch.Tensor   # (N, 3)
    pdf: torch.Tensor        # (N,) solid-angle pdf, pick pmf included
    is_delta: torch.Tensor   # (N,) bool
    emitter_id: torch.Tensor  # (N,) int32
    # bidirectional MIS extras, with vcm=True only (zero for the kinds
    # BDPT treats apart: constant, directional, envmap)
    cos_light: torch.Tensor = None       # (N,) cos at the emitter toward p (1 point-like)
    emission_pdf_w: torch.Tensor = None  # (N,) pick * pdf_pos_A * pdf_dir_W of emitting it


def kinds_present(em: Emitters):
    """Static tuple of emitter kinds in a scene (host read)."""
    return tuple(sorted(set(em.kind.cpu().tolist())))


def _pick_emitter(em: Emitters, u0: torch.Tensor) -> torch.Tensor:
    """CDF inversion: searchsorted(cdf, u0, side='right') clipped to the
    table, as a dense compare-and-count for up to 128 emitters."""
    e = em.cdf.shape[0]
    if e <= 128:
        eid = torch.sum((em.cdf[:, None] <= u0[None, :]).to(torch.int32), dim=0)
    else:
        eid = torch.searchsorted(em.cdf, u0.contiguous(), right=True)
    return torch.clamp(eid, 0, em.kind.shape[0] - 1).to(torch.int32)


def sample_direct(em: Emitters, geo: Geometry, p: torch.Tensor, u: torch.Tensor,
                  kinds=PORTED_KINDS, vcm: bool = False) -> DirectSample:
    """One emitter sample per lane; u (N, 3): u[:, 0] picks the emitter,
    u[:, 1:3] the point or direction on it.  ``kinds`` is the static tuple
    of kinds present: only those branches run.  ``vcm`` adds
    ``cos_light`` and ``emission_pdf_w``."""
    n = p.shape[0]
    dev = p.device
    eid = _pick_emitter(em, u[..., 0])
    row = gather_rows_t(em.packed, eid)  # (32, N)
    kind = row[0].to(torch.int32)
    pmf = row[1]
    rad = torch.stack([row[2], row[3], row[4]], dim=-1)
    u2 = u[..., 1:3]

    direction = torch.zeros((n, 3), device=dev)
    distance = torch.full((n,), INFD, device=dev)
    radiance = torch.zeros((n, 3), device=dev)
    pdf = pmf
    is_delta = torch.zeros((n,), dtype=torch.bool, device=dev)
    far = torch.full((n,), INFD, device=dev)
    cos_light = emission_pdf_w = None
    if vcm:
        cos_light = torch.zeros((n,), device=dev)
        emission_pdf_w = torch.zeros((n,), device=dev)

    def put(sel, d_, dist_, rad_, pdf_, delta_):
        nonlocal direction, distance, radiance, pdf, is_delta
        direction = torch.where(sel[..., None], d_, direction)
        distance = torch.where(sel, dist_, distance)
        radiance = torch.where(sel[..., None], rad_, radiance)
        pdf = torch.where(sel, pdf_, pdf)
        is_delta = torch.where(sel, delta_, is_delta)

    if K.AREA in kinds:
        # uniform point on the emissive triangle (packed p0, e1, e2, normal)
        b = square_to_uniform_triangle(u2)
        q = torch.stack(
            [
                row[14] + b[..., 0] * row[17] + b[..., 1] * row[20],
                row[15] + b[..., 0] * row[18] + b[..., 1] * row[21],
                row[16] + b[..., 0] * row[19] + b[..., 1] * row[22],
            ],
            dim=-1,
        )
        ng = torch.stack([row[23], row[24], row[25]], dim=-1)
        to_q = q - p
        dist2 = torch.clamp_min(dot(to_q, to_q), 1e-12)
        dist = torch.sqrt(dist2)
        dir_a = to_q / dist[..., None]
        cos_l = dot(ng, -dir_a)
        area = torch.clamp_min(row[13], 1e-12)
        pdf_a = pmf * dist2 / torch.clamp_min(torch.abs(cos_l) * area, 1e-12)
        rad_a = torch.where((cos_l > 0.0)[..., None], rad, 0.0)
        sel_area = kind == K.AREA
        put(sel_area, dir_a, dist, rad_a, pdf_a, torch.zeros_like(is_delta))
        if vcm:
            cos_light = torch.where(sel_area, torch.clamp_min(cos_l, 0.0), cos_light)
            emission_pdf_w = torch.where(
                sel_area, pmf / area * torch.clamp_min(cos_l, 0.0) / math.pi, emission_pdf_w)

    if K.POINT in kinds or K.SPOT in kinds:
        pos = torch.stack([row[5], row[6], row[7]], dim=-1)
        to_l = pos - p
        d2p = torch.clamp_min(dot(to_l, to_l), 1e-12)
        distp = torch.sqrt(d2p)
        dir_p = to_l / distp[..., None]
        if K.POINT in kinds:
            sel_pt = kind == K.POINT
            put(sel_pt, dir_p, distp, rad / d2p[..., None], pmf, torch.ones_like(is_delta))
            if vcm:
                cos_light = torch.where(sel_pt, 1.0, cos_light)
                emission_pdf_w = torch.where(sel_pt, pmf * INV_FOURPI, emission_pdf_w)
        if K.SPOT in kinds:
            axis = torch.stack([row[8], row[9], row[10]], dim=-1)
            cos_total = row[11]
            cos_beam = row[12]
            cd = dot(axis, -dir_p)
            falloff = torch.clamp(
                (cd - cos_total) / torch.clamp_min(cos_beam - cos_total, 1e-6), 0.0, 1.0)
            rad_s = rad / d2p[..., None] * torch.where(cd > cos_total, falloff, 0.0)[..., None]
            sel_sp = kind == K.SPOT
            put(sel_sp, dir_p, distp, rad_s, pmf, torch.ones_like(is_delta))
            if vcm:
                cos_light = torch.where(sel_sp, 1.0, cos_light)
                emission_pdf_w = torch.where(
                    sel_sp, pmf / (2.0 * math.pi * torch.clamp_min(1.0 - cos_total, 1e-6)),
                    emission_pdf_w)

    if K.CONSTANT in kinds:
        put(kind == K.CONSTANT, square_to_uniform_sphere(u2), far, rad, pmf * INV_FOURPI,
            torch.zeros_like(is_delta))

    if K.DIRECTIONAL in kinds:
        dir_dl = -torch.stack([row[5], row[6], row[7]], dim=-1)
        put(kind == K.DIRECTIONAL, dir_dl, far, rad, pmf, torch.ones_like(is_delta))

    if K.ENVMAP in kinds:
        d_env, pdf_tex, rad_env = env_sample(em, u2)
        put(kind == K.ENVMAP, d_env, far, rad_env, pmf * pdf_tex, torch.zeros_like(is_delta))

    return DirectSample(
        direction=direction,
        distance=distance,
        radiance=radiance,
        pdf=torch.clamp_min(pdf, 1e-12),
        is_delta=is_delta,
        emitter_id=eid,
        cos_light=cos_light,
        emission_pdf_w=emission_pdf_w,
    )


def eval_hit(em: Emitters, geo: Geometry, eid, wo_world, prim):
    """Radiance emitted toward the viewer by the emissive triangle a BSDF
    ray hit (one-sided: the side of its geometric normal)."""
    ng = normalize(cross(geo.e1[prim], geo.e2[prim]))
    front = dot(ng, -wo_world) > 0.0
    return torch.where((eid >= 0)[..., None] & front[..., None],
                       em.radiance[torch.clamp_min(eid, 0)], 0.0)


def pdf_direct_hit(em: Emitters, geo: Geometry, eid, p, q, wo_world):
    """Solid-angle NEE pdf of having sampled the point ``q`` of the
    emissive triangle a BSDF ray from ``p`` hit (the MIS companion)."""
    e = torch.clamp_min(eid, 0)
    tri = torch.clamp_min(em.tri[e], 0)
    ng = normalize(cross(geo.e1[tri], geo.e2[tri]))
    to_q = q - p
    dist2 = torch.clamp_min(dot(to_q, to_q), 1e-12)
    cos_l = torch.abs(dot(ng, -wo_world))
    pdf = em.pmf[e] * dist2 / torch.clamp_min(cos_l * torch.clamp_min(em.area[e], 1e-12), 1e-12)
    return torch.where(eid >= 0, pdf, 0.0)


def pdf_env(em: Emitters, d=None, kinds=None):
    """Solid-angle NEE pdf of the environment toward ``d``: the constant
    environment's pick pmf / 4 pi (0 without one), or, with ENVMAP among
    ``kinds``, the pick pmf times the texel's pdf."""
    if kinds is not None and K.ENVMAP in kinds:
        return em.env_pdf * env_pdf_dir(em, d)
    return em.env_pdf


def eval_env(em: Emitters, wo_world, kinds=None):
    """Environment radiance for escaped rays (0 without one)."""
    if kinds is not None and K.ENVMAP in kinds:
        return env_eval(em, wo_world)
    return em.env_radiance.expand(wo_world.shape)


class RaySample(NamedTuple):
    """Emitter-ray sample for adjoint transport (the light-path
    integrators' start)."""

    o: torch.Tensor       # (N, 3) ray origin
    d: torch.Tensor       # (N, 3) ray direction, away from the emitter
    weight: torch.Tensor  # (N, 3) Le / (pdf_pos pdf_dir pmf): the particle's power
    normal: torch.Tensor  # (N, 3) emitter normal at o (0 for point-like)
    valid: torch.Tensor   # (N,) bool
    emit_weight: torch.Tensor  # (N, 3) Le / (pdf_pos pmf), emitter-to-sensor connections
    emission_pdf_w: torch.Tensor  # (N,) pick * pdf_pos_A * pdf_dir_W
    direct_pdf_a: torch.Tensor    # (N,) pick * pdf_pos_A (infinite: solid-angle NEE pdf)
    cos_light: torch.Tensor       # (N,) cos between the emitter normal and d
    infinite: torch.Tensor        # (N,) bool: constant, envmap, directional


def scene_radius(aabb_min, aabb_max):
    """The bounding sphere's radius of the infinite emitters' disk (a 0-d
    tensor; ``trace_bdpt`` reads the same)."""
    return 0.5 * torch.linalg.vector_norm(aabb_max - aabb_min) + 1e-3


def sample_ray(em: Emitters, aabb_min, aabb_max, u: torch.Tensor,
               kinds=PORTED_KINDS) -> RaySample:
    """A (position, direction) on the scene's emitters per lane, for
    particle tracing.  ``u`` (N, 5): 0 picks the emitter, 1:3 the
    position, 3:5 the direction.  Infinite emitters (constant, envmap,
    directional) emit from a disk of the bounding sphere's radius facing
    the scene, 1.5 radii from its centre."""
    n = u.shape[0]
    dev = u.device
    eid = _pick_emitter(em, u[..., 0])
    row = gather_rows_t(em.packed, eid)  # (32, N)
    kind = row[0].to(torch.int32)
    pmf = torch.clamp_min(row[1], 1e-12)
    rad = torch.stack([row[2], row[3], row[4]], dim=-1)
    u_pos = u[..., 1:3]
    u_dir = u[..., 3:5]

    center = (aabb_min + aabb_max) * 0.5
    radius = scene_radius(aabb_min, aabb_max)
    disk_area = math.pi * radius * radius

    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.zeros((n, 3), **f32)
    d = torch.zeros((n, 3), **f32)
    w = torch.zeros((n, 3), **f32)
    nrm = torch.zeros((n, 3), **f32)
    valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    emit_w = torch.zeros((n, 3), **f32)
    emission_pdf_w = torch.zeros((n,), **f32)
    direct_pdf_a = torch.zeros((n,), **f32)
    cos_light = torch.zeros((n,), **f32)
    infinite = torch.zeros((n,), dtype=torch.bool, device=dev)

    def put(sel, o_, d_, w_, n_):
        nonlocal o, d, w, nrm, valid
        o = torch.where(sel[..., None], o_, o)
        d = torch.where(sel[..., None], d_, d)
        w = torch.where(sel[..., None], w_, w)
        nrm = torch.where(sel[..., None], n_, nrm)
        valid = valid | sel

    def vcm(sel, emission_, direct_, cos_):
        nonlocal emission_pdf_w, direct_pdf_a, cos_light
        emission_pdf_w = torch.where(sel, emission_, emission_pdf_w)
        direct_pdf_a = torch.where(sel, direct_, direct_pdf_a)
        cos_light = torch.where(sel, cos_, cos_light)

    def disk_point(dir_in, u2):
        """Point of the bounding-sphere disk facing ``dir_in``."""
        dxy = square_to_uniform_disk_concentric(u2) * radius
        off = Frame.from_normal(dir_in).to_world(
            torch.cat([dxy, torch.zeros_like(dxy[..., :1])], dim=-1))
        return center - dir_in * radius * 1.5 + off

    if K.AREA in kinds:
        b = square_to_uniform_triangle(u_pos)
        q = torch.stack(
            [
                row[14] + b[..., 0] * row[17] + b[..., 1] * row[20],
                row[15] + b[..., 0] * row[18] + b[..., 1] * row[21],
                row[16] + b[..., 0] * row[19] + b[..., 1] * row[22],
            ],
            dim=-1,
        )
        ng = torch.stack([row[23], row[24], row[25]], dim=-1)
        d_local = square_to_cosine_hemisphere(u_dir)
        d_world = Frame.from_normal(ng).to_world(d_local)
        area = torch.clamp_min(row[13], 1e-12)
        # Le cos / (pmf / A * cos / pi) = Le * pi * A / pmf
        sel_a = kind == K.AREA
        put(sel_a, q + ng * 1e-4, d_world, rad * (math.pi * area / pmf)[..., None], ng)
        emit_w = torch.where(sel_a[..., None], rad * (area / pmf)[..., None], emit_w)
        cos_a = torch.clamp_min(d_local[..., 2], 0.0)
        vcm(sel_a, pmf / area * cos_a / math.pi, pmf / area, cos_a)

    if K.POINT in kinds or K.SPOT in kinds:
        pos = torch.stack([row[5], row[6], row[7]], dim=-1)
        if K.POINT in kinds:
            sel_p = kind == K.POINT
            put(sel_p, pos, square_to_uniform_sphere(u_dir),
                rad * (4.0 * math.pi / pmf)[..., None], torch.zeros_like(pos))
            vcm(sel_p, pmf * INV_FOURPI, pmf, 1.0)
        if K.SPOT in kinds:
            axis = torch.stack([row[8], row[9], row[10]], dim=-1)
            cos_total = row[11]
            cos_beam = row[12]
            # uniform cone sampling
            ct = 1.0 - u_dir[..., 0] * (1.0 - cos_total)
            st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
            ph = 2.0 * math.pi * u_dir[..., 1]
            local = torch.stack([st * torch.cos(ph), st * torch.sin(ph), ct], dim=-1)
            d_cone = Frame.from_normal(axis).to_world(local)
            falloff = torch.clamp(
                (ct - cos_total) / torch.clamp_min(cos_beam - cos_total, 1e-6), 0.0, 1.0)
            solid = 2.0 * math.pi * torch.clamp_min(1.0 - cos_total, 1e-6)
            sel_s = kind == K.SPOT
            put(sel_s, pos, d_cone, rad * (falloff * solid / pmf)[..., None],
                torch.zeros_like(pos))
            vcm(sel_s, pmf / solid, pmf, 1.0)

    if K.DIRECTIONAL in kinds:
        # position uniform on the bounding disk, direction delta; the
        # direct pdf is the discrete NEE pick probability
        d_dl = torch.stack([row[5], row[6], row[7]], dim=-1)  # the emitted direction
        sel_dl = kind == K.DIRECTIONAL
        put(sel_dl, disk_point(d_dl, u_pos), d_dl, rad * (disk_area / pmf)[..., None], d_dl)
        vcm(sel_dl, pmf / disk_area, pmf, 1.0)

    if K.COLLIMATED in kinds:
        # one delta ray: origin and axis fixed, weight power / pmf
        pos_c = torch.stack([row[5], row[6], row[7]], dim=-1)
        axis_c = torch.stack([row[8], row[9], row[10]], dim=-1)
        sel_cl = kind == K.COLLIMATED
        put(sel_cl, pos_c, axis_c, rad / pmf[..., None], torch.zeros_like(pos_c))
        vcm(sel_cl, pmf, 0.0, 1.0)

    if K.CONSTANT in kinds:
        d_in = -square_to_uniform_sphere(u_dir)  # inward
        sel_c = kind == K.CONSTANT
        put(sel_c, disk_point(d_in, u_pos), d_in,
            rad * (disk_area * 4.0 * math.pi / pmf)[..., None], d_in)
        # the direct pdf is NEE's solid-angle pdf; emission adds the disk's
        pd_c = pmf * INV_FOURPI
        vcm(sel_c, pd_c / disk_area, pd_c, 1.0)
        infinite = infinite | sel_c

    if K.ENVMAP in kinds:
        d_env, pdf_tex, rad_env = env_sample(em, u_dir)
        d_in_e = -d_env
        sel_e = kind == K.ENVMAP
        put(sel_e, disk_point(d_in_e, u_pos), d_in_e,
            rad_env * (disk_area / (torch.clamp_min(pdf_tex, 1e-12) * pmf))[..., None], d_in_e)
        pd_e = pmf * pdf_tex
        vcm(sel_e, pd_e / disk_area, pd_e, 1.0)
        infinite = infinite | sel_e

    if K.DIRECTIONAL in kinds:
        infinite = infinite | (kind == K.DIRECTIONAL)

    return RaySample(o=o, d=d, weight=w, normal=nrm, valid=valid, emit_weight=emit_w,
                     emission_pdf_w=emission_pdf_w, direct_pdf_a=direct_pdf_a,
                     cos_light=cos_light, infinite=infinite)
