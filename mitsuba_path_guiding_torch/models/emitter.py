"""Emitter sampling for next-event estimation (port of the reference's
models/emitter.py: ``kinds_present``, ``_pick_emitter``, ``sample_direct``
for the AREA, POINT, SPOT, CONSTANT, DIRECTIONAL and ENVMAP kinds, and
``eval_env`` / ``pdf_env``, which give zero when the scene has no
environment light).  A COLLIMATED emitter radiates along one ray: its NEE
sample carries no radiance, as in the reference.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_path_guiding_torch.core.math import dot
from mitsuba_path_guiding_torch.core.warp import (
    INV_FOURPI,
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
                  kinds=PORTED_KINDS) -> DirectSample:
    """One emitter sample per lane; u (N, 3): u[:, 0] picks the emitter,
    u[:, 1:3] the point or direction on it.  ``kinds`` is the static tuple
    of kinds present: only those branches run."""
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
        put(kind == K.AREA, dir_a, dist, rad_a, pdf_a, torch.zeros_like(is_delta))

    if K.POINT in kinds or K.SPOT in kinds:
        pos = torch.stack([row[5], row[6], row[7]], dim=-1)
        to_l = pos - p
        d2p = torch.clamp_min(dot(to_l, to_l), 1e-12)
        distp = torch.sqrt(d2p)
        dir_p = to_l / distp[..., None]
        if K.POINT in kinds:
            put(kind == K.POINT, dir_p, distp, rad / d2p[..., None], pmf,
                torch.ones_like(is_delta))
        if K.SPOT in kinds:
            axis = torch.stack([row[8], row[9], row[10]], dim=-1)
            cos_total = row[11]
            cos_beam = row[12]
            cd = dot(axis, -dir_p)
            falloff = torch.clamp(
                (cd - cos_total) / torch.clamp_min(cos_beam - cos_total, 1e-6), 0.0, 1.0)
            rad_s = rad / d2p[..., None] * torch.where(cd > cos_total, falloff, 0.0)[..., None]
            put(kind == K.SPOT, dir_p, distp, rad_s, pmf, torch.ones_like(is_delta))

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
    )


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
