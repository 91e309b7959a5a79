"""Wavefront BSDF layer: the DIFFUSE and ROUGH_CONDUCTOR families (port of
the reference's models/bsdf.py ``gather_params``, ``eval_pdf``,
``sample`` and ``albedo``).

Conventions are the reference's: directions in the local shading frame
(+z = shading normal), ``wi`` toward the previous vertex, ``eval`` returns
f * |cos(wo)|, ``sample`` returns (wo, weight = f cos / pdf, pdf,
is_delta), reflective families act two-sided.  ``types`` is the static
tuple of families present; any other family raises (ROADMAP Queue 1
item 5).  The rough conductor is GGX with visible-normal sampling and
the conductor Fresnel term.

Every entry point takes either ``(mats, mid)`` or, through the ``*_p``
variants, the lane's material row already gathered by ``gather_params``:
the path tracer fetches that row once per bounce and reuses it for NEE
evaluation, sampling and the albedo AOV, which gives the same values as
the reference's repeated gathers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_path_guiding_torch.core.math import cos_theta, dot, fresnel_conductor, normalize
from mitsuba_path_guiding_torch.core.warp import (
    INV_PI,
    square_to_cosine_hemisphere,
    square_to_cosine_hemisphere_pdf,
)
from mitsuba_path_guiding_torch.models.microfacet import (
    ALPHA_MIN,
    ggx_d,
    ggx_g1,
    ggx_g2,
    ggx_sample_vndf,
    ggx_vndf_pdf,
)
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import BSDFType, Materials

PORTED_TYPES = (BSDFType.DIFFUSE, BSDFType.ROUGH_CONDUCTOR)


class BSDFSample(NamedTuple):
    wo: torch.Tensor        # (N, 3) local frame
    weight: torch.Tensor    # (N, 3) f * cos / pdf
    pdf: torch.Tensor       # (N,) solid-angle pdf
    is_delta: torch.Tensor  # (N,) bool


class _P(NamedTuple):
    """Per-lane gathered material parameters (those the ported families
    read; the other families add theirs when they are ported)."""

    type: torch.Tensor
    refl: torch.Tensor
    spec: torch.Tensor
    eta: torch.Tensor
    k: torch.Tensor
    alpha: torch.Tensor


def check_types(types) -> None:
    missing = sorted(set(types) - set(PORTED_TYPES))
    if missing:
        raise NotImplementedError(
            f"BSDF families {missing} are not ported yet: ROADMAP Queue 1 item 5")


def types_present(mats: Materials):
    """Static tuple of BSDF types used by a scene (host read)."""
    return tuple(sorted(set(mats.type.cpu().tolist())))


def gather_params(mats: Materials, mid: torch.Tensor, tex=None) -> _P:
    """One packed material-row gather per lane (``Materials.packed``)."""
    if tex is not None:
        raise NotImplementedError("textured reflectance: ROADMAP Queue 1 item 9")
    row = gather_rows_t(mats.packed, mid)  # (32, N)

    def v3(a):
        return torch.stack([row[a], row[a + 1], row[a + 2]], dim=-1)

    return _P(type=row[0].to(torch.int32), refl=v3(1), spec=v3(4), eta=v3(7), k=v3(10),
              alpha=torch.clamp_min(row[13], ALPHA_MIN))


def _flip_two_sided(wi):
    """Reflective families act two-sided: flip wi into the upper
    hemisphere.  Returns (wi_flipped, sign)."""
    s = torch.where(cos_theta(wi) >= 0.0, 1.0, -1.0)
    return torch.stack([wi[..., 0], wi[..., 1], wi[..., 2] * s], dim=-1), s


def _diffuse_eval_pdf(p: _P, wi, wo):
    up = (cos_theta(wi) > 0.0) & (cos_theta(wo) > 0.0)
    f = p.refl * (INV_PI * torch.clamp_min(cos_theta(wo), 0.0))[..., None]
    pdf = square_to_cosine_hemisphere_pdf(wo)
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


def _rough_conductor_eval_pdf(p: _P, wi, wo):
    up = (cos_theta(wi) > 1e-6) & (cos_theta(wo) > 1e-6)
    m = normalize(wi + wo)
    D = ggx_d(m, p.alpha)
    G2 = ggx_g2(wi, wo, p.alpha)
    F = fresnel_conductor(dot(wi, m), p.eta, p.k)
    ci = torch.clamp_min(cos_theta(wi), 1e-6)
    f = p.spec * F * (D * G2 / (4.0 * ci))[..., None]
    pdf = ggx_vndf_pdf(wi, m, p.alpha) / torch.clamp_min(4.0 * torch.abs(dot(m, wo)), 1e-8)
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


_EVALS = {BSDFType.DIFFUSE: _diffuse_eval_pdf,
          BSDFType.ROUGH_CONDUCTOR: _rough_conductor_eval_pdf}


def eval_pdf_p(p: _P, wi, wo, types=PORTED_TYPES):
    """(f*cos (N,3), pdf (N,)) from gathered parameters."""
    check_types(types)
    wi2, s = _flip_two_sided(wi)
    wo2 = torch.stack([wo[..., 0], wo[..., 1], wo[..., 2] * s], dim=-1)
    f = torch.zeros_like(wi2)
    pdf = torch.zeros_like(wi2[..., 0])
    for t, fn in _EVALS.items():
        if t in types:
            ft, pt = fn(p, wi2, wo2)
            sel = p.type == t
            f = torch.where(sel[..., None], ft, f)
            pdf = torch.where(sel, pt, pdf)
    return f, pdf


def sample_p(p: _P, wi, u, types=PORTED_TYPES) -> BSDFSample:
    """BSDF sampling from gathered parameters; u (N, 3)."""
    check_types(types)
    wi2, s = _flip_two_sided(wi)
    u2 = u[..., 0:2]
    wo = torch.zeros_like(wi)
    weight = torch.zeros_like(wi)
    pdf = torch.zeros_like(wi[..., 0])

    def put(sel, wo_c, w_c, pdf_c):
        return (torch.where(sel[..., None], wo_c, wo), torch.where(sel[..., None], w_c, weight),
                torch.where(sel, pdf_c, pdf))

    if BSDFType.DIFFUSE in types:
        wo_cos = square_to_cosine_hemisphere(u2)
        wo, weight, pdf = put(p.type == BSDFType.DIFFUSE, wo_cos, p.refl,
                              square_to_cosine_hemisphere_pdf(wo_cos))
    if BSDFType.ROUGH_CONDUCTOR in types:
        m = ggx_sample_vndf(wi2, p.alpha, u2)
        wo_rc = 2.0 * dot(wi2, m)[..., None] * m - wi2
        ok = cos_theta(wo_rc) > 1e-6  # below-horizon reflections are rejected
        F = fresnel_conductor(dot(wi2, m), p.eta, p.k)
        g1 = torch.clamp_min(ggx_g1(wi2, p.alpha), 1e-8)
        w_rc = p.spec * F * (ggx_g2(wi2, wo_rc, p.alpha) / g1)[..., None]
        pdf_rc = ggx_vndf_pdf(wi2, m, p.alpha) / torch.clamp_min(
            4.0 * torch.abs(dot(m, wo_rc)), 1e-8)
        wo, weight, pdf = put(p.type == BSDFType.ROUGH_CONDUCTOR, wo_rc,
                              torch.where(ok[..., None], w_rc, 0.0),
                              torch.where(ok, pdf_rc, 0.0))
    wo = torch.stack([wo[..., 0], wo[..., 1], wo[..., 2] * s], dim=-1)
    is_delta = torch.zeros(wi.shape[:-1], dtype=torch.bool, device=wi.device)
    return BSDFSample(wo=wo, weight=weight, pdf=pdf, is_delta=is_delta)


def albedo_p(p: _P) -> torch.Tensor:
    """BSDF::getAlbedo: the reflectance, the specular tint for conductors."""
    return torch.where((p.type == BSDFType.ROUGH_CONDUCTOR)[..., None], p.spec, p.refl)


def eval_pdf(mats: Materials, mid, wi, wo, types=PORTED_TYPES, tex=None, cloth_aux=None):
    return eval_pdf_p(gather_params(mats, mid, tex), wi, wo, types)


def sample(mats: Materials, mid, wi, u, types=PORTED_TYPES, tex=None, cloth_aux=None) -> BSDFSample:
    return sample_p(gather_params(mats, mid, tex), wi, u, types)


def albedo(mats: Materials, mid):
    return albedo_p(gather_params(mats, mid))
