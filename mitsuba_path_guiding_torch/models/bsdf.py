"""Wavefront BSDF layer (port of the reference's models/bsdf.py
``gather_params``, ``eval_pdf``, ``sample`` and ``albedo``): every family
present is evaluated on the whole wavefront and each lane keeps the
result of its own material type.

Conventions are the reference's: directions in the local shading frame
(+z = shading normal), ``wi`` toward the previous vertex, ``eval`` returns
f * |cos(wo)|, ``sample`` returns (wo, weight = f cos / pdf, pdf,
is_delta) and uses u[..., 0:2] for the direction and u[..., 2] for the
lobe; delta lobes have a discrete pdf and are invisible to eval/pdf.
Reflective families act two-sided; DIELECTRIC, ROUGH_DIELECTRIC, NULL and
THINDIELECTRIC keep the side of ``wi``.  ``types`` is the static tuple of
families present.

Ported families: DIFFUSE, ROUGH_DIFFUSE (Oren-Nayar), CONDUCTOR,
ROUGH_CONDUCTOR (GGX, visible normals), DIELECTRIC, ROUGH_DIELECTRIC,
THINDIELECTRIC, PLASTIC, ROUGH_PLASTIC, PHONG, WARD, DIFFTRANS, NULL, HK
(the Hanrahan-Krueger slab), CLOTH (the Irawan-Marschner woven cloth:
the band-gated filament/staple specular integrand at the lane's yarn
record, ``cloth_aux``, or without one the uv-averaged Ward fit; sampled
from the cosine hemisphere), and the one-level wrappers BLEND
(``blendbsdf`` / ``mixturebsdf``), MASK and COATING (a dielectric layer
over its nested row; ``roughcoating`` is a COATING row with alpha > 0).

A texture overrides the reflectance (``apply_texture``): ``tex`` = (rgb
(N, 3), mask (N,)) replaces ``refl`` where the mask is set, in the lane's
own row and in its nested rows, as the reference does; the albedo AOV is
read from the untextured row, as in the reference.

Every entry point takes either ``(mats, mid)`` or, through the ``*_p``
variants, the lane's material row already gathered by ``gather_params``:
the path tracer fetches that row once per bounce and reuses it for NEE
evaluation, sampling and the albedo AOV.  When BLEND, MASK or COATING is
among the types, ``gather_params`` also fetches the two nested rows, in a
second ``gather_rows_t`` call, and with COATING the lane's row of the
(M, 16) coat transmittance table (``Materials.coat_trans``) in a third;
the reference gathers them again at each use, which gives the same
values.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mitsuba_path_guiding_torch.core.math import (
    Frame,
    cos_theta,
    dot,
    fresnel_conductor,
    fresnel_dielectric,
    normalize,
    reflect_local,
    refract_local,
    safe_sqrt,
)
from mitsuba_path_guiding_torch.core.warp import (
    INV_FOURPI,
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
from mitsuba_path_guiding_torch.models.phase import hg_pdf, phase_sample
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import BSDFType, Materials
from mitsuba_path_guiding_torch.utils.stats import host_read

T = BSDFType
PORTED_TYPES = (T.DIFFUSE, T.CONDUCTOR, T.DIELECTRIC, T.ROUGH_CONDUCTOR, T.PLASTIC,
                T.ROUGH_DIELECTRIC, T.NULL, T.ROUGH_PLASTIC, T.ROUGH_DIFFUSE, T.PHONG, T.MASK,
                T.WARD, T.DIFFTRANS, T.BLEND, T.COATING, T.HK, T.THINDIELECTRIC, T.CLOTH)
NESTED_TYPES = (T.BLEND, T.MASK, T.COATING)
# The reference's tuple of every type.  TWO_SIDED is a build-time flag that
# no material row holds: ``check_types`` lets it pass, and no branch reads it.
ALL_TYPES = tuple(range(T.N_TYPES))


class BSDFSample(NamedTuple):
    wo: torch.Tensor        # (N, 3) local frame
    weight: torch.Tensor    # (N, 3) f * cos / pdf
    pdf: torch.Tensor       # (N,) solid-angle pdf (discrete for delta lobes)
    is_delta: torch.Tensor  # (N,) bool


class _P(NamedTuple):
    """Per-lane gathered material parameters."""

    type: torch.Tensor
    refl: torch.Tensor
    spec: torch.Tensor
    eta: torch.Tensor
    k: torch.Tensor
    alpha: torch.Tensor
    alpha_v: torch.Tensor
    sub_a: torch.Tensor    # int32 nested material row (-1 none)
    sub_b: torch.Tensor
    weight: torch.Tensor   # blend factor / mask opacity / coat or slab thickness
    extra: torch.Tensor    # (N, 5) packed columns 27:32 (the cloth's geometry)
    tcoat: Optional[torch.Tensor] = None  # (16, N) coat transmittance row, see gather_params
    nested: Optional[tuple] = None  # (_P of sub_a, _P of sub_b), see gather_params
    cloth_aux: Optional[tuple] = None  # the lane's yarn record (weft, u, v, ks scale)

    N_OWN = 11  # the per-lane fields of the row itself, before tcoat and nested


def check_types(types) -> None:
    missing = sorted(set(types) - set(PORTED_TYPES) - {T.TWO_SIDED})
    if missing:
        raise NotImplementedError(
            f"BSDF families {missing} are not ported")


def types_present(mats: Materials):
    """Static tuple of BSDF types used by a scene (host read)."""
    return tuple(sorted(set(host_read(mats.type, "bsdf.types_present").tolist())))


def _has_nested(types) -> bool:
    return any(t in types for t in NESTED_TYPES)


def _has_blend_mask(types) -> bool:
    return T.BLEND in types or T.MASK in types


def _row_params(row) -> _P:
    def v3(a):
        return torch.stack([row[a], row[a + 1], row[a + 2]], dim=-1)

    return _P(type=row[0].to(torch.int32), refl=v3(1), spec=v3(4), eta=v3(7), k=v3(10),
              alpha=torch.clamp_min(row[13], ALPHA_MIN),
              alpha_v=torch.clamp_min(row[15], ALPHA_MIN),
              sub_a=row[16].to(torch.int32), sub_b=row[17].to(torch.int32), weight=row[18],
              extra=row[27:32].T)


def apply_texture(p: _P, tex=None, cloth_aux=None) -> _P:
    """``p`` with the texture's reflectance override (tex = (rgb (N, 3),
    mask (N,)), in the lane's row and its nested rows) and the lane's
    cloth yarn record."""
    if tex is not None:
        t_rgb, t_mask = tex

        def over(q):
            return q._replace(refl=torch.where(t_mask[..., None], t_rgb, q.refl))

        p = over(p)
        if p.nested is not None:
            p = p._replace(nested=tuple(over(q) for q in p.nested))
    return p._replace(cloth_aux=cloth_aux) if cloth_aux is not None else p


def gather_params(mats: Materials, mid: torch.Tensor, tex=None, *, types, cloth_aux=None,
                  row=None) -> _P:
    """One packed material-row gather per lane (``Materials.packed``; or
    ``row``, that gather's (32, N) result when the caller made it); when
    BLEND, MASK or COATING is among ``types``, one more for both nested
    rows of every lane (sub_a and sub_b, clamped to row 0 where absent);
    and with COATING, the lane's coat transmittance row (a table of 16
    columns) where the table exists.  ``tex`` and ``cloth_aux`` go through
    ``apply_texture``."""
    p = _row_params(gather_rows_t(mats.packed, mid) if row is None else row)  # (32, N)
    if _has_nested(types):
        n = mid.shape[0]
        sub = torch.cat([torch.clamp_min(p.sub_a, 0), torch.clamp_min(p.sub_b, 0)])
        rows = gather_rows_t(mats.packed, sub)  # (32, 2N)
        p = p._replace(nested=(_row_params(rows[:, :n]), _row_params(rows[:, n:])))
    if T.COATING in types and mats.coat_trans is not None:
        p = p._replace(tcoat=gather_rows_t(mats.coat_trans, mid))  # (16, N)
    return apply_texture(p, tex, cloth_aux)


def _nested(p: _P):
    if p.nested is None:
        raise ValueError("BLEND/MASK/COATING lanes need gather_params(..., types) with those types")
    return p.nested


def _flip_z(w, s):
    return torch.stack([w[..., 0], w[..., 1], w[..., 2] * s], dim=-1)


def _flip_two_sided(p: _P, wi):
    """Reflective families act two-sided: flip wi into the upper
    hemisphere.  Returns (wi_flipped, sign); wo is un-flipped with the
    same sign.  The transmissive families keep their side (sign 1)."""
    transmissive = ((p.type == T.DIELECTRIC) | (p.type == T.ROUGH_DIELECTRIC)
                    | (p.type == T.NULL) | (p.type == T.HK) | (p.type == T.THINDIELECTRIC))
    s = torch.where(transmissive | (cos_theta(wi) >= 0.0), 1.0, -1.0)
    return _flip_z(wi, s), s


def _fdr_int(eta):
    """Average internal Fresnel reflectance (d'Eon's fit) for plastic."""
    return torch.where(
        eta < 1.0,
        -0.4399 + 0.7099 / eta - 0.3319 / (eta * eta) + 0.0636 / (eta * eta * eta),
        -1.4399 / (eta * eta) + 0.7099 / eta + 0.6681 + 0.0636 * eta,
    )


# ---------------------------------------------------------------------------
# per-family eval (f * |cos_o|) and pdf of the smooth lobes
# ---------------------------------------------------------------------------

def _diffuse_eval_pdf(p: _P, wi, wo):
    up = (cos_theta(wi) > 0.0) & (cos_theta(wo) > 0.0)
    f = p.refl * (INV_PI * torch.clamp_min(cos_theta(wo), 0.0))[..., None]
    pdf = square_to_cosine_hemisphere_pdf(wo)
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


def _orennayar_eval_pdf(p: _P, wi, wo):
    up = (cos_theta(wi) > 0.0) & (cos_theta(wo) > 0.0)
    sigma = p.alpha
    s2 = sigma * sigma
    A = 1.0 - s2 / (2.0 * (s2 + 0.33))
    B = 0.45 * s2 / (s2 + 0.09)
    ci, co = cos_theta(wi), cos_theta(wo)
    si = safe_sqrt(1.0 - ci * ci)
    so = safe_sqrt(1.0 - co * co)
    denom = torch.clamp_min(si * so, 1e-7)
    cos_dphi = torch.clamp((wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / denom, -1.0, 1.0)
    sin_alpha = torch.maximum(si, so)
    tan_beta = torch.minimum(si / torch.clamp_min(ci, 1e-7), so / torch.clamp_min(co, 1e-7))
    f = p.refl * (INV_PI * torch.clamp_min(co, 0.0)
                  * (A + B * torch.clamp_min(cos_dphi, 0.0) * sin_alpha * tan_beta))[..., None]
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


def _plastic_lobe_probs(p: _P, wi):
    fi = fresnel_dielectric(torch.abs(cos_theta(wi)), p.eta[..., 0])
    return torch.clamp(fi, 0.05, 0.95), fi


def _plastic_diffuse(p: _P, wi, wo, eta):
    """The internally scattered diffuse lobe of both plastics (f * cos)."""
    fi = fresnel_dielectric(cos_theta(wi), eta)
    fo = fresnel_dielectric(cos_theta(wo), eta)
    fdr = _fdr_int(eta)
    inv_eta2 = 1.0 / (eta * eta)
    return (p.refl / torch.clamp_min(1.0 - p.refl * fdr[..., None], 1e-3)
            * (INV_PI * torch.clamp_min(cos_theta(wo), 0.0) * (1.0 - fi) * (1.0 - fo)
               * inv_eta2)[..., None])


def _plastic_eval_pdf(p: _P, wi, wo):
    """Smooth plastic: a delta coat (invisible here) over an internally
    scattered diffuse base."""
    up = (cos_theta(wi) > 0.0) & (cos_theta(wo) > 0.0)
    f = _plastic_diffuse(p, wi, wo, p.eta[..., 0])
    spec_prob, _ = _plastic_lobe_probs(p, wi)
    pdf = (1.0 - spec_prob) * square_to_cosine_hemisphere_pdf(wo)
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


def _rough_plastic_eval_pdf(p: _P, wi, wo):
    up = (cos_theta(wi) > 1e-6) & (cos_theta(wo) > 1e-6)
    eta = p.eta[..., 0]
    m = normalize(wi + wo)
    D = ggx_d(m, p.alpha)
    G2 = ggx_g2(wi, wo, p.alpha)
    Fm = fresnel_dielectric(dot(wi, m), eta)
    ci = torch.clamp_min(cos_theta(wi), 1e-6)
    f_spec = p.spec * (Fm * D * G2 / (4.0 * ci))[..., None]
    f_diff = _plastic_diffuse(p, wi, wo, eta)
    spec_prob, _ = _plastic_lobe_probs(p, wi)
    pdf_spec = ggx_vndf_pdf(wi, m, p.alpha) / torch.clamp_min(4.0 * torch.abs(dot(m, wo)), 1e-8)
    pdf = spec_prob * pdf_spec + (1.0 - spec_prob) * square_to_cosine_hemisphere_pdf(wo)
    f = f_spec + f_diff
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


def _phong_exponent(p: _P):
    return torch.clamp(2.0 / torch.clamp_min(p.alpha * p.alpha, 1e-6) - 2.0, 1.0, 1e5)


def _spec_lobe_prob(p: _P):
    """Pick probability of the specular lobe of Phong and Ward."""
    ks = torch.mean(p.spec, dim=-1)
    kd = torch.mean(p.refl, dim=-1)
    return torch.clamp(ks / torch.clamp_min(ks + kd, 1e-9), 0.05, 0.95)


def _phong_eval_pdf(p: _P, wi, wo):
    """Modified Phong."""
    up = (cos_theta(wi) > 0.0) & (cos_theta(wo) > 0.0)
    n = _phong_exponent(p)
    r = reflect_local(wi)
    cos_r = torch.clamp_min(dot(r, wo), 0.0)
    co = torch.clamp_min(cos_theta(wo), 0.0)
    lobe = torch.pow(cos_r, n)
    f = (p.refl * (INV_PI * co)[..., None]
         + p.spec * ((n + 2.0) / (2.0 * math.pi) * lobe * co)[..., None])
    spec_prob = _spec_lobe_prob(p)
    pdf_spec = (n + 1.0) / (2.0 * math.pi) * lobe
    pdf = spec_prob * pdf_spec + (1.0 - spec_prob) * square_to_cosine_hemisphere_pdf(wo)
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


def _rough_dielectric_eval_pdf(p: _P, wi, wo):
    """GGX rough glass (Walter et al. 2007), computed where wi lies in the
    upper hemisphere (s = sign(cos_i)), the microfacet normal kept upper.
    The lobe pick is the microfacet Fresnel F(wi.m), as in sampling, so
    sample and pdf agree under total internal reflection too."""
    eta = p.eta[..., 0]
    ci = cos_theta(wi)
    s = torch.where(ci >= 0.0, 1.0, -1.0)
    wi_f = _flip_z(wi, s)
    wo_f = _flip_z(wo, s)
    eta_rel = torch.where(ci >= 0.0, eta, 1.0 / eta)
    reflect_side = cos_theta(wo_f) > 0.0

    m_r = normalize(wi_f + wo_f)
    m_t = normalize(wi_f + eta_rel[..., None] * wo_f)
    m_t = m_t * torch.sign(cos_theta(m_t) + 1e-20)[..., None]
    m = torch.where(reflect_side[..., None], m_r, m_t)

    wim = dot(wi_f, m)
    wom = dot(wo_f, m)
    F = fresnel_dielectric(wim, eta_rel)
    D = ggx_d(m, p.alpha)
    G = ggx_g2(wi_f, wo_f, p.alpha)
    aci = torch.clamp_min(torch.abs(ci), 1e-6)
    pdf_m = ggx_vndf_pdf(wi_f, m, p.alpha)

    f_r = F * D * G / (4.0 * aci)
    pdf_r = F * pdf_m / torch.clamp_min(4.0 * torch.abs(wom), 1e-8)
    valid_r = reflect_side & (wim > 1e-6) & (wom > 1e-6)

    denom_t = wim + eta_rel * wom
    dt2 = torch.clamp_min(denom_t * denom_t, 1e-10)
    jac_t = eta_rel * eta_rel * torch.abs(wom) / dt2
    f_t = torch.abs(wim) * torch.abs(wom) * (1.0 - F) * D * G / (aci * dt2)
    pdf_t = (1.0 - F) * pdf_m * jac_t
    valid_t = (~reflect_side) & (wim > 1e-6) & (wom < -1e-6)

    f = torch.where(valid_r, f_r, torch.where(valid_t, f_t, 0.0))
    pdf = torch.where(valid_r, pdf_r, torch.where(valid_t, pdf_t, 0.0))
    return p.spec * f[..., None], pdf


def _ward_C(p: _P, m):
    """Anisotropic exponent tan^2(theta_h) * C(phi_h) of half vector m."""
    c2 = cos_theta(m) ** 2
    return ((m[..., 0] ** 2 / (p.alpha * p.alpha) + m[..., 1] ** 2 / (p.alpha_v * p.alpha_v))
            / torch.clamp_min(c2, 1e-8))


def _ward_h_pdf(p: _P, m):
    c = torch.clamp_min(cos_theta(m), 1e-6)
    return torch.exp(-_ward_C(p, m)) / (math.pi * p.alpha * p.alpha_v * c * c * c)


def _ward_eval_pdf(p: _P, wi, wo):
    """Anisotropic Ward-Duer, with Walter's 2005 sampling density."""
    ci, co = cos_theta(wi), cos_theta(wo)
    up = (ci > 1e-6) & (co > 1e-6)
    m = normalize(wi + wo)
    expo = torch.exp(-_ward_C(p, m))
    f_spec = p.spec * (expo / torch.clamp_min(
        4.0 * math.pi * p.alpha * p.alpha_v * torch.sqrt(torch.clamp_min(ci * co, 1e-8)),
        1e-8) * co)[..., None]
    f = p.refl * (INV_PI * torch.clamp_min(co, 0.0))[..., None] + f_spec
    sp = _spec_lobe_prob(p)
    pdf_spec = _ward_h_pdf(p, m) / torch.clamp_min(4.0 * torch.abs(dot(m, wo)), 1e-8)
    pdf = sp * pdf_spec + (1.0 - sp) * square_to_cosine_hemisphere_pdf(wo)
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


def _difftrans_eval_pdf(p: _P, wi, wo):
    """Diffuse transmission: wo on the side opposite wi (here: wi up,
    wo down)."""
    thru = (cos_theta(wi) > 0.0) & (cos_theta(wo) < 0.0)
    aco = torch.abs(cos_theta(wo))
    f = p.refl * (INV_PI * aco)[..., None]
    pdf = aco * INV_PI
    return torch.where(thru[..., None], f, 0.0), torch.where(thru, pdf, 0.0)


def _hk_params(p: _P):
    """sigma_s = refl, sigma_a = k, thickness = weight, HG g = eta[..., 0]."""
    sigma_t = p.refl + p.k
    tau_d = sigma_t * p.weight[..., None]
    albedo = p.refl / torch.clamp_min(sigma_t, 1e-9)
    return tau_d, albedo, p.eta[..., 0]


def _hk_prob_delta(tau_d, cos_i):
    """Mean attenuated transmittance: the pick probability of the delta
    transmission lobe."""
    return torch.mean(torch.exp(-tau_d / torch.clamp_min(torch.abs(cos_i), 1e-6)[..., None]),
                      dim=-1)


def _hk_eval_pdf(p: _P, wi, wo):
    """Hanrahan-Krueger single-scattering slab, its smooth lobes (the
    reflection and transmission terms of Hanrahan et al. 93 times
    |cos_o|); the delta transmission is invisible here."""
    tau_d, albedo, g = _hk_params(p)
    ci, co = cos_theta(wi), cos_theta(wo)
    aci, aco = torch.clamp_min(torch.abs(ci), 1e-6), torch.clamp_min(torch.abs(co), 1e-6)
    ph = torch.where(torch.abs(g) < 1e-4, INV_FOURPI, hg_pdf(dot(-wi, wo), g))
    f_r = (albedo * (ph * ci / torch.clamp_min(ci + co, 1e-6))[..., None]
           * (1.0 - torch.exp((-1.0 / aci - 1.0 / aco)[..., None] * tau_d)))
    # the grazing-equal case of the transmission term apart
    same = torch.abs(aci - aco) < 1e-5
    t_gen = ((ph * aci)[..., None] / torch.where(same, 1.0, aci - aco)[..., None]
             * (torch.exp(-tau_d / aci[..., None]) - torch.exp(-tau_d / aco[..., None])))
    t_same = (ph * 1.0)[..., None] * tau_d / aco[..., None] * torch.exp(-tau_d / aco[..., None])
    f_t = albedo * torch.where(same[..., None], t_same, t_gen)
    f = torch.where((ci * co > 0)[..., None], f_r, f_t) * aco[..., None]
    # the phase pdf times the share of the smooth lobes
    pdf = ph * (1.0 - _hk_prob_delta(tau_d, ci))
    return torch.clamp_min(f, 0.0), torch.clamp_min(pdf, 0.0)


# ---------------------------------------------------------------------------
# woven cloth (Irawan-Marschner).  The weave geometry is baked at build
# time (models/cloth.py: a kd texture and a yarn-record texture, fetched
# nearest); the specular integrand below is written once over an ``xp``
# namespace, so that the build-time Monte Carlo normalization (numpy, in
# float64) runs the same math as the per-lane eval (torch, ``_TorchXP``).
# Sampling is the cosine hemisphere.  The validity guards (ss in [0, 1),
# w sin(umax) < l, kappa >= -1) are enforced at build time.
# ---------------------------------------------------------------------------

class _TorchXP:
    """The numpy names the cloth integrand uses, on torch tensors; the
    first argument of ``maximum``, ``minimum`` and ``clip`` is a tensor,
    the bounds tensors or Python numbers."""

    sqrt, exp, abs, sin, cos, tan = torch.sqrt, torch.exp, torch.abs, torch.sin, torch.cos, \
        torch.tan
    sinh, cosh, zeros_like = torch.sinh, torch.cosh, torch.zeros_like
    arctan, arctan2, arctanh, arccos = torch.atan, torch.atan2, torch.atanh, torch.acos
    maximum, minimum = torch.clamp_min, torch.clamp_max

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp_max(torch.clamp_min(x, lo), hi)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def sum(x, axis):
        return torch.sum(x, dim=axis)

    @staticmethod
    def stack(xs, axis):
        return torch.stack(xs, dim=axis)


def _cloth_smoothstep(x, xp):
    x = xp.clip(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def _cloth_von_mises(cos_x, b, xp):
    """exp(b cos x) / (2 pi I0(b)), Abramowitz-Stegun polynomial I0."""
    ab = xp.abs(b)
    t_s = (ab / 3.75) ** 2
    i0_s = 1.0 + t_s * (3.5156229 + t_s * (3.0899424 + t_s * (1.2067492
           + t_s * (0.2659732 + t_s * (0.0360768 + t_s * 0.0045813)))))
    t_l = 3.75 / xp.maximum(ab, 1e-9)
    i0_l = xp.exp(ab) / xp.sqrt(xp.maximum(ab, 1e-9)) * (
        0.39894228 + t_l * (0.01328592 + t_l * (0.00225319 + t_l * (
            -0.00157565 + t_l * (0.00916281 + t_l * (-0.02057706 + t_l * (
                0.02635537 + t_l * (-0.01647633 + t_l * 0.00392377)))))))
    )
    i0 = xp.where(ab <= 3.75, i0_s, i0_l)
    return xp.exp(b * cos_x) / (2.0 * math.pi * i0)


def _cloth_seeliger(c1, c2, xp):
    c1 = xp.maximum(c1, 0.0)
    c2 = xp.maximum(c2, 0.0)
    return xp.where(
        (c1 > 0) & (c2 > 0),
        c1 * c2 / (4.0 * math.pi * xp.maximum(c1 + c2, 1e-12)),
        xp.zeros_like(c1),
    )


def _cloth_radius(u, umax, kappa, w, l, xp):
    """The yarn spine's radius of curvature: ellipse, hyperbola, parabola
    or cylinder by the sign of rhat.  Every branch is computed on clamped
    inputs, so the branches not taken stay finite."""
    a = 0.5 * w
    tan_umax = xp.tan(umax)
    rhat = 1.0 + kappa * (1.0 + 1.0 / xp.maximum(tan_umax, 1e-9))
    rim = 0.5 * l - a * xp.sin(umax)  # > 0 by the build-time validity check
    # elliptic (rhat > 0)
    rh_e = xp.maximum(rhat, 1e-6)
    tmax_e = xp.arctan(rh_e * tan_umax)
    bhat_e = rim / xp.maximum(xp.sin(tmax_e), 1e-9)
    ahat_e = bhat_e / rh_e
    t_e = xp.arctan(rh_e * xp.tan(u))
    R_e = (bhat_e ** 2 * xp.cos(t_e) ** 2
           + ahat_e ** 2 * xp.sin(t_e) ** 2) ** 1.5 / xp.maximum(
        ahat_e * bhat_e, 1e-12)
    # hyperbolic (rhat < 0)
    rh_h = xp.minimum(rhat, -1e-6)
    tmax_h = -xp.arctanh(xp.clip(rh_h * tan_umax, -0.999999, 0.999999))
    sh = xp.sinh(tmax_h)
    bhat_h = rim / xp.where(xp.abs(sh) < 1e-9, 1e-9, sh)
    ahat_h = bhat_h / rh_h
    t_h = -xp.arctanh(xp.clip(rh_h * xp.tan(u), -0.999999, 0.999999))
    den_h = ahat_h * bhat_h
    R_h = -(bhat_h ** 2 * xp.cosh(t_h) ** 2
            + ahat_h ** 2 * xp.sinh(t_h) ** 2) ** 1.5 / xp.where(
        xp.abs(den_h) < 1e-12, -1e-12, den_h)
    # parabolic (rhat == 0)
    ahat_p = rim / xp.maximum(2.0 * tan_umax, 1e-9)
    R_p = 2.0 * ahat_p * (1.0 + xp.tan(u) ** 2) ** 1.5
    # straight spine (rhat == 1): constant R
    R_c = rim / xp.maximum(xp.sin(umax), 1e-9) + xp.zeros_like(u)
    return xp.where(
        xp.abs(rhat - 1.0) < 1e-9, R_c,
        xp.where(rhat > 0.0, R_e, xp.where(rhat < 0.0, R_h, R_p)),
    )


def _cloth_filament(u, v, oi, orr, alpha, beta, ss, umax, kappa, w, l, h_width, xp):
    """The filament-yarn (psi = 0) specular integrand, gated to the
    highlight band |y(u(v)) - y(u)| < delta_y / 2."""
    hs = oi + orr
    sum_len = xp.sqrt(xp.maximum(xp.sum(hs * hs, axis=-1), 1e-18))
    h = hs / sum_len[..., None]
    u_of_v = xp.arctan2(h[..., 1], xp.maximum(h[..., 2], 1e-12))
    in_range = xp.abs(u_of_v) < umax
    # the normal at the reflection locus (u_of_v, v)
    nx = xp.sin(v)
    ny = xp.sin(u_of_v) * xp.cos(v)
    nz = xp.cos(u_of_v) * xp.cos(v)
    nl = xp.sqrt(xp.maximum(nx * nx + ny * ny + nz * nz, 1e-18))
    n_i = (nx * oi[..., 0] + ny * oi[..., 1] + nz * oi[..., 2]) / nl
    n_r = (nx * orr[..., 0] + ny * orr[..., 1] + nz * orr[..., 2]) / nl
    a = 0.5 * w
    R = _cloth_radius(
        xp.minimum(xp.abs(u_of_v), (1.0 - ss) * umax),
        (1.0 - ss) * umax, kappa, w, l, xp)
    # t = (0, cos u_of_v, -sin u_of_v); (t x h)_x = cos(u) h_z + sin(u) h_y
    tchx = xp.cos(u_of_v) * h[..., 2] + xp.sin(u_of_v) * h[..., 1]
    Gu = a * (R + a * xp.cos(v)) / xp.maximum(sum_len * xp.abs(tchx), 1e-12)
    fc = alpha + _cloth_von_mises(-xp.sum(oi * orr, axis=-1), beta, xp)
    A = _cloth_seeliger(n_i, n_r, xp)
    ss_fac = 1.0 - _cloth_smoothstep(
        (xp.abs(u_of_v) - (1.0 - ss) * umax) / xp.maximum(ss * umax, 1e-9), xp)
    A = xp.where(ss > 0.0, A * ss_fac, A)
    fs = Gu * fc * A * math.pi * l
    delta_y = l * h_width
    y_scale = 0.5 * l / xp.maximum(umax, 1e-6)
    y_of_v = xp.clip(u_of_v * y_scale, 0.5 * (delta_y - l), 0.5 * (l - delta_y))
    on_band = xp.abs(y_of_v - u * y_scale) < 0.5 * delta_y
    return xp.where(in_range & on_band, fs / delta_y, xp.zeros_like(fs))


def _cloth_staple(u, v, oi, orr, alpha, beta, psi, umax, kappa, w, l, h_width, xp):
    """The staple-yarn (psi != 0) integrand: the reflection locus is v(u)."""
    hs = oi + orr
    sum_len = xp.sqrt(xp.maximum(xp.sum(hs * hs, axis=-1), 1e-18))
    h = hs / sum_len[..., None]
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    D = (hy * xp.cos(u) - hz * xp.sin(u)) / (
        xp.sqrt(xp.maximum(hx ** 2 + (hy * xp.sin(u) + hz * xp.cos(u)) ** 2, 1e-18))
        * xp.where(xp.abs(xp.tan(psi)) < 1e-6, 1e-6, xp.tan(psi)))
    v_of_u = xp.arctan2(-hy * xp.sin(u) - hz * xp.cos(u), hx) + xp.arccos(xp.clip(D, -1.0, 1.0))
    in_range = (xp.abs(D) < 1.0) & (xp.abs(v_of_u) < math.pi / 2.0)
    nx = xp.sin(v_of_u)
    ny = xp.sin(u) * xp.cos(v_of_u)
    nz = xp.cos(u) * xp.cos(v_of_u)
    nl = xp.sqrt(xp.maximum(nx * nx + ny * ny + nz * nz, 1e-18))
    n_i = (nx * oi[..., 0] + ny * oi[..., 1] + nz * oi[..., 2]) / nl
    n_r = (nx * orr[..., 0] + ny * orr[..., 1] + nz * orr[..., 2]) / nl
    n_h = (nx * hx + ny * hy + nz * hz) / nl
    a = 0.5 * w
    R = _cloth_radius(xp.abs(u), umax, kappa, w, l, xp)
    Gv = a * (R + a * xp.cos(v_of_u)) / xp.maximum(
        sum_len * xp.maximum(n_h, 1e-9) * xp.abs(xp.sin(psi)), 1e-12)
    fc = alpha + _cloth_von_mises(-xp.sum(oi * orr, axis=-1), beta, xp)
    A = _cloth_seeliger(n_i, n_r, xp)
    fs = Gv * fc * A * 2.0 * w * umax
    delta_x = w * h_width
    x_of_u = xp.clip(v_of_u * w / math.pi, 0.5 * (delta_x - w), 0.5 * (w - delta_x))
    on_band = xp.abs(x_of_u - v * w / math.pi) < 0.5 * delta_x
    return xp.where(in_range & on_band, fs / delta_x, xp.zeros_like(fs))


def cloth_spec_raw(wi, wo, weft, u, v, alpha, beta, ss, psi, umax, kappa,
                   w, l, h_width, area_warp, area_weft, xp=_TorchXP):
    """The unnormalized Irawan specular (the area-weighted integrand) at a
    yarn record (weft, u, v) for local directions wi, wo (+z the base
    shading normal); weft lanes turn a quarter about z into the yarn's
    frame.  ``xp`` is numpy for the build-time normalization, else torch."""
    wfm = weft[..., None]
    oi = xp.where(wfm, xp.stack([-wi[..., 1], wi[..., 0], wi[..., 2]], axis=-1), wi)
    orr = xp.where(wfm, xp.stack([-wo[..., 1], wo[..., 0], wo[..., 2]], axis=-1), wo)
    fil = _cloth_filament(u, v, oi, orr, alpha, beta, ss, umax, kappa, w, l, h_width, xp)
    stp = _cloth_staple(u, v, oi, orr, alpha, beta, psi, umax, kappa, w, l, h_width, xp)
    integ = xp.where(xp.abs(psi) > 1e-7, stp, fil)
    return integ * xp.where(weft, area_weft, area_warp)


def _cloth_scalars(p: _P):
    """The repurposed CLOTH columns (scene/types.py)."""
    return dict(
        vm_alpha=p.eta[..., 0], beta=p.eta[..., 1], ss=p.eta[..., 2],
        psi=p.k[..., 0], umax=p.k[..., 1], kappa=p.k[..., 2],
        h_width=p.weight, a_fb=p.alpha, norm=p.alpha_v,
        w=p.extra[..., 0], l=p.extra[..., 1],
        area_warp=p.extra[..., 2], area_weft=p.extra[..., 3], fb_scale=p.extra[..., 4],
    )


def _cloth_eval_pdf(p: _P, wi, wo, aux=None):
    """f*cos and pdf of CLOTH lanes.  With the lane's yarn record ``aux``
    = (weft, u, v, ks scale) the band-gated integrand runs; without it,
    the build-time uv-averaged isotropic Ward fit (energy-matched by
    fb_scale).  The pdf is the cosine hemisphere's either way."""
    c = _cloth_scalars(p)
    ci, co = cos_theta(wi), cos_theta(wo)
    up = (ci > 1e-6) & (co > 1e-6)
    if aux is not None:
        weft, u_p, v_p, ks_s = aux
        raw = cloth_spec_raw(wi, wo, weft, u_p, v_p, c["vm_alpha"], c["beta"], c["ss"],
                             c["psi"], c["umax"], c["kappa"], c["w"], c["l"], c["h_width"],
                             c["area_warp"], c["area_weft"])
        spec_s = raw * c["norm"] * ks_s
    else:
        m = normalize(wi + wo)
        a2 = torch.clamp_min(c["a_fb"] * c["a_fb"], 1e-6)
        ct2 = torch.clamp_min(m[..., 2] * m[..., 2], 1e-8)
        tan2 = (m[..., 0] ** 2 + m[..., 1] ** 2) / ct2
        ward = torch.exp(-tan2 / a2) / (
            4.0 * math.pi * a2 * torch.sqrt(torch.clamp_min(ci * co, 1e-8)))
        spec_s = ward * c["fb_scale"]
    f = (p.refl * INV_PI + p.spec * spec_s[..., None]) * torch.clamp_min(co, 0.0)[..., None]
    pdf = square_to_cosine_hemisphere_pdf(wo)
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


_SMOOTH_EVALS = {
    T.HK: _hk_eval_pdf,
    T.DIFFUSE: _diffuse_eval_pdf,
    T.ROUGH_DIFFUSE: _orennayar_eval_pdf,
    T.ROUGH_CONDUCTOR: _rough_conductor_eval_pdf,
    T.PLASTIC: _plastic_eval_pdf,
    T.ROUGH_PLASTIC: _rough_plastic_eval_pdf,
    T.PHONG: _phong_eval_pdf,
    T.ROUGH_DIELECTRIC: _rough_dielectric_eval_pdf,
    T.WARD: _ward_eval_pdf,
    T.DIFFTRANS: _difftrans_eval_pdf,
}


def _eval_smooth(p: _P, wi2, wo2, types):
    """Family-dispatched smooth eval/pdf on already-flipped directions."""
    f = torch.zeros_like(wi2)
    pdf = torch.zeros_like(wi2[..., 0])
    for t, fn in _SMOOTH_EVALS.items():
        if t in types:
            ft, pt = fn(p, wi2, wo2)
            sel = p.type == t
            f = torch.where(sel[..., None], ft, f)
            pdf = torch.where(sel, pt, pdf)
    return f, pdf


def _coat_refract(w, eta_ratio):
    """Hemisphere-keeping refraction across the coat interface: the
    tangential part scaled by 1/eta_ratio, z keeps its sign.  Returns
    (w_t, R), R = 1 under total internal reflection."""
    inv = 1.0 / eta_ratio
    cz = w[..., 2]
    st2 = torch.clamp_min(1.0 - cz * cz, 0.0) * inv * inv
    ct = safe_sqrt(1.0 - st2)
    w_t = torch.stack([w[..., 0] * inv, w[..., 1] * inv, torch.sign(cz) * ct], dim=-1)
    R = fresnel_dielectric(torch.abs(cz), eta_ratio)
    return w_t, torch.where(st2 >= 1.0, 1.0, R)


def _coat_rough_reflection(p: _P, wi, wo):
    """The GGX reflection off a rough coat interface: the coat's alpha,
    dielectric Fresnel at the half vector.  Returns (f*cos, pdf)."""
    up = (cos_theta(wi) > 1e-6) & (cos_theta(wo) > 1e-6)
    m = normalize(wi + wo)
    D = ggx_d(m, p.alpha)
    G2 = ggx_g2(wi, wo, p.alpha)
    F = fresnel_dielectric(dot(wi, m), torch.clamp_min(p.eta[..., 0], 1e-3))
    ci = torch.clamp_min(cos_theta(wi), 1e-6)
    f = p.spec * (F * D * G2 / (4.0 * ci))[..., None]
    pdf = ggx_vndf_pdf(wi, m, p.alpha) / torch.clamp_min(4.0 * torch.abs(dot(m, wo)), 1e-8)
    return torch.where(up[..., None], f, 0.0), torch.where(up, pdf, 0.0)


def _interp_coat_trans(tcoat, cos_v):
    """Linear interpolation of the (16, N) coat rows at |cos_v| per lane."""
    n_cos = tcoat.shape[0]
    x = torch.clamp(torch.abs(cos_v), 0.0, 1.0) * (n_cos - 1)
    i0 = torch.clamp(x.to(torch.int64), 0, n_cos - 2)
    t = x - i0.to(x.dtype)
    v0 = torch.gather(tcoat, 0, i0[None])[0]
    v1 = torch.gather(tcoat, 0, (i0 + 1)[None])[0]
    return v0 * (1.0 - t) + v1 * t


def _coating_f_pdf(p: _P, pc: _P, wi2, wo2, types, tcoat=None):
    """Smooth eval/pdf of a coat over its nested row ``pc``: both
    directions refracted into the layer, the nested lobe evaluated there,
    attenuated by the two interface transmittances and the absorption of
    the layer, and the measure converted back (1/eta^2 and the cosine
    ratio).  A rough interface (alpha > 0) adds its GGX reflection to the
    eval, and its pdf with probability R12.  ``tcoat``: the lanes' rows of
    the transmittance table, which replace the smooth 1 - F on a rough
    interface."""
    eta_c = torch.clamp_min(p.eta[..., 0], 1e-3)
    wi_in, R12 = _coat_refract(wi2, eta_c)
    wo_in, R21 = _coat_refract(wo2, eta_c)
    f_n, pdf_n = _eval_smooth(pc, wi_in, wo_in, types)
    inv_eta2 = 1.0 / (eta_c * eta_c)
    czo_in = torch.where(torch.abs(wo_in[..., 2]) < 1e-6, 1e-6, wo_in[..., 2])
    cos_ratio = wo2[..., 2] / czo_in
    sa = p.refl * p.weight[..., None]  # sigma_a x thickness
    absorb = torch.exp(-sa * (1.0 / torch.clamp_min(torch.abs(wi_in[..., 2]), 1e-6)
                              + 1.0 / torch.clamp_min(torch.abs(wo_in[..., 2]), 1e-6))[..., None])
    t12, t21 = (1.0 - R12), (1.0 - R21)
    if tcoat is not None:
        rough_if = p.alpha > 1e-3
        t12 = torch.where(rough_if, _interp_coat_trans(tcoat, wi2[..., 2]), t12)
        t21 = torch.where(rough_if, _interp_coat_trans(tcoat, wo2[..., 2]), t21)
    trans = t12 * t21 * inv_eta2 * cos_ratio
    ok = (R12 < 1.0) & (R21 < 1.0)
    f_c = torch.where(ok[..., None], f_n * absorb * trans[..., None], 0.0)
    pdf_c = torch.where(ok, (1.0 - R12) * pdf_n * inv_eta2 * cos_ratio, 0.0)
    f_r, pdf_r = _coat_rough_reflection(p, wi2, wo2)
    rough_c = p.alpha > 1e-3
    f_c = torch.where(rough_c[..., None], f_c + f_r, f_c)
    pdf_c = torch.where(rough_c, pdf_c + R12 * pdf_r, pdf_c)
    return f_c, pdf_c


def eval_pdf_p(p: _P, wi, wo, types=PORTED_TYPES):
    """(f*cos (N,3), pdf (N,)) of the smooth lobes from gathered
    parameters; 0 for delta lobes.  BLEND lanes mix their nested lobes by
    weight; MASK lanes scale the nested lobe by the opacity (the
    pass-through is a delta lobe); COATING lanes take the coat over their
    nested lobe (``_coating_f_pdf``); CLOTH lanes their integrand at
    ``p.cloth_aux``.  Nested rows evaluate the smooth families without
    CLOTH, as in the reference."""
    check_types(types)
    wi2, s = _flip_two_sided(p, wi)
    wo2 = _flip_z(wo, s)
    f, pdf = _eval_smooth(p, wi2, wo2, types)
    if T.CLOTH in types:
        f_cl, pdf_cl = _cloth_eval_pdf(p, wi2, wo2, p.cloth_aux)
        is_cl = p.type == T.CLOTH
        f = torch.where(is_cl[..., None], f_cl, f)
        pdf = torch.where(is_cl, pdf_cl, pdf)
    if _has_blend_mask(types):
        pa, pb = _nested(p)
        fa, pdfa = _eval_smooth(pa, wi2, wo2, types)
        if T.BLEND in types:
            fb, pdfb = _eval_smooth(pb, wi2, wo2, types)
            is_b = p.type == T.BLEND
            w = p.weight
            f = torch.where(is_b[..., None], (1.0 - w)[..., None] * fa + w[..., None] * fb, f)
            pdf = torch.where(is_b, (1.0 - w) * pdfa + w * pdfb, pdf)
        if T.MASK in types:
            is_m = p.type == T.MASK
            f = torch.where(is_m[..., None], p.weight[..., None] * fa, f)
            pdf = torch.where(is_m, p.weight * pdfa, pdf)
    if T.COATING in types:
        f_c, pdf_c = _coating_f_pdf(p, _nested(p)[0], wi2, wo2, types, p.tcoat)
        is_c = p.type == T.COATING
        f = torch.where(is_c[..., None], f_c, f)
        pdf = torch.where(is_c, pdf_c, pdf)
    return f, pdf


def _albedo_of(p: _P):
    spec_like = (p.type == T.CONDUCTOR) | (p.type == T.ROUGH_CONDUCTOR)
    glassy = ((p.type == T.DIELECTRIC) | (p.type == T.ROUGH_DIELECTRIC)
              | (p.type == T.THINDIELECTRIC))
    a = torch.where(spec_like[..., None], p.spec, p.refl)
    return torch.where(glassy[..., None], 1.0, a)


def albedo_p(p: _P) -> torch.Tensor:
    """BSDF::getAlbedo: the reflectance, the specular tint for conductors,
    1 for glass; BLEND lerps and MASK scales its nested rows' albedo, and
    COATING takes its nested row's."""
    a = _albedo_of(p)
    if p.nested is not None:
        pa, pb = p.nested
        aa, ab = _albedo_of(pa), _albedo_of(pb)
        w = p.weight[..., None]
        a = torch.where((p.type == T.BLEND)[..., None], (1.0 - w) * aa + w * ab, a)
        a = torch.where((p.type == T.MASK)[..., None], w * aa, a)
        a = torch.where((p.type == T.COATING)[..., None], aa, a)
    return a


def _sample_families(p: _P, wi, u2, ul, types, cloth_aux=None) -> BSDFSample:
    """Sample the plain families on the wavefront, select by type; CLOTH
    lanes weigh their cosine sample with the integrand at ``cloth_aux``."""
    def has(*ts):
        return any(t in types for t in ts)

    wi2, s = _flip_two_sided(p, wi)
    wo = torch.zeros_like(wi)
    weight = torch.zeros_like(wi)
    pdf = torch.zeros_like(wi[..., 0])
    is_delta = torch.zeros(wi.shape[:-1], dtype=torch.bool, device=wi.device)
    no = torch.zeros_like(is_delta)
    yes = torch.ones_like(is_delta)

    def put(sel, wo_c, w_c, pdf_c, delta_c):
        nonlocal wo, weight, pdf, is_delta
        wo = torch.where(sel[..., None], wo_c, wo)
        weight = torch.where(sel[..., None], w_c, weight)
        pdf = torch.where(sel, pdf_c, pdf)
        is_delta = torch.where(sel, delta_c, is_delta)

    eta_s = p.eta[..., 0]
    if has(T.DIFFUSE, T.ROUGH_DIFFUSE, T.PLASTIC, T.ROUGH_PLASTIC, T.PHONG, T.WARD, T.DIFFTRANS,
           T.CLOTH):
        wo_cos = square_to_cosine_hemisphere(u2)
        pdf_cos = square_to_cosine_hemisphere_pdf(wo_cos)
    if has(T.CONDUCTOR, T.PLASTIC):
        wo_mirror = reflect_local(wi2)

    if has(T.DIFFUSE):
        put(p.type == T.DIFFUSE, wo_cos, p.refl, pdf_cos, no)

    if has(T.CLOTH):
        f_cl, _ = _cloth_eval_pdf(p, wi2, wo_cos, cloth_aux)
        w_cl = f_cl / torch.clamp_min(pdf_cos, 1e-9)[..., None]
        put(p.type == T.CLOTH, wo_cos, w_cl, pdf_cos, no)

    if has(T.ROUGH_DIFFUSE):
        f_on, _ = _orennayar_eval_pdf(p, wi2, wo_cos)
        put(p.type == T.ROUGH_DIFFUSE, wo_cos, f_on / torch.clamp_min(pdf_cos, 1e-8)[..., None],
            pdf_cos, no)

    if has(T.DIFFTRANS):
        # the cosine lobe on the other side (here: below)
        put(p.type == T.DIFFTRANS, _flip_z(wo_cos, -1.0), p.refl, pdf_cos, no)

    if has(T.WARD):
        # anisotropic half-vector sampling (Walter 2005, eq. 6-7) mixed with
        # a cosine diffuse lobe
        take_spec_w = ul < _spec_lobe_prob(p)
        phi2 = 2.0 * math.pi * u2[..., 1]
        hx = p.alpha * torch.cos(phi2)
        hy = p.alpha_v * torch.sin(phi2)
        norm = torch.sqrt(hx * hx + hy * hy)
        cphi = hx / torch.clamp_min(norm, 1e-12)
        sphi = hy / torch.clamp_min(norm, 1e-12)
        C = cphi * cphi / (p.alpha * p.alpha) + sphi * sphi / (p.alpha_v * p.alpha_v)
        tan2 = -torch.log(torch.clamp_min(u2[..., 0], 1e-9)) / torch.clamp_min(C, 1e-12)
        ct = 1.0 / torch.sqrt(1.0 + tan2)
        st = safe_sqrt(1.0 - ct * ct)
        m_w = torch.stack([st * cphi, st * sphi, ct], dim=-1)
        wo_w_spec = 2.0 * dot(wi2, m_w)[..., None] * m_w - wi2
        wo_w = torch.where(take_spec_w[..., None], wo_w_spec, wo_cos)
        f_w, pdf_w = _ward_eval_pdf(p, wi2, wo_w)
        ok_w = (cos_theta(wo_w) > 1e-6) & (pdf_w > 1e-9)
        w_w = f_w / torch.clamp_min(pdf_w, 1e-9)[..., None]
        put(p.type == T.WARD, wo_w, torch.where(ok_w[..., None], w_w, 0.0),
            torch.where(ok_w, pdf_w, 0.0), no)

    if has(T.CONDUCTOR):
        F_c = fresnel_conductor(cos_theta(wi2), p.eta, p.k)
        put(p.type == T.CONDUCTOR, wo_mirror, p.spec * F_c, torch.ones_like(pdf), yes)

    if has(T.DIELECTRIC):
        # delta reflection or refraction, on the side of the signed wi
        F_d = fresnel_dielectric(cos_theta(wi), eta_s)
        refl_choice = ul < F_d
        wo_refr, _ = refract_local(wi, eta_s)
        rel_eta = torch.where(cos_theta(wi) > 0.0, eta_s, 1.0 / eta_s)
        wo_d = torch.where(refl_choice[..., None], reflect_local(wi), wo_refr)
        w_d = torch.where(refl_choice[..., None], p.spec,
                          p.spec / torch.clamp_min(rel_eta * rel_eta, 1e-8)[..., None])
        pdf_d = torch.where(refl_choice, F_d, 1.0 - F_d)
        put(p.type == T.DIELECTRIC, wo_d, w_d, pdf_d, yes)

    if has(T.THINDIELECTRIC):
        # a zero-thickness slab: the interior bounces sum to R' = 2R/(1+R),
        # and transmitted rays leave parallel to wi
        F_t = fresnel_dielectric(torch.abs(cos_theta(wi)), eta_s)
        Rp = torch.where(F_t < 1.0, 2.0 * F_t / (1.0 + F_t), 1.0)
        refl_t = ul < Rp
        wo_t = torch.where(refl_t[..., None], reflect_local(wi), -wi)
        put(p.type == T.THINDIELECTRIC, wo_t, p.spec, torch.where(refl_t, Rp, 1.0 - Rp), yes)

    if has(T.NULL):
        put(p.type == T.NULL, -wi, torch.ones_like(weight), torch.ones_like(pdf), yes)

    if has(T.HK):
        # the attenuated delta transmission, picked with its mean
        # transmittance, else an HG direction inside the slab
        tau_d, _, g_hk = _hk_params(p)
        ci_hk = cos_theta(wi2)
        p_delta = _hk_prob_delta(tau_d, ci_hk)
        take_delta = ul < p_delta
        w_delta = (torch.exp(-tau_d / torch.clamp_min(torch.abs(ci_hk), 1e-6)[..., None])
                   / torch.clamp_min(p_delta, 1e-9)[..., None])
        wo_ph, _ = phase_sample(wi2, g_hk, u2)
        f_hk, pdf_hk = _hk_eval_pdf(p, wi2, wo_ph)
        w_s = f_hk / torch.clamp_min(pdf_hk, 1e-9)[..., None]
        ok_s = pdf_hk > 1e-9
        put(p.type == T.HK, torch.where(take_delta[..., None], -wi2, wo_ph),
            torch.where(take_delta[..., None], w_delta, torch.where(ok_s[..., None], w_s, 0.0)),
            torch.where(take_delta, torch.clamp_min(p_delta, 1e-9), pdf_hk), take_delta)

    if has(T.ROUGH_CONDUCTOR, T.ROUGH_PLASTIC):
        m = ggx_sample_vndf(wi2, p.alpha, u2)
        wo_rc = 2.0 * dot(wi2, m)[..., None] * m - wi2

    if has(T.ROUGH_CONDUCTOR):
        ok = cos_theta(wo_rc) > 1e-6  # below-horizon reflections are rejected
        F_rc = fresnel_conductor(dot(wi2, m), p.eta, p.k)
        g1 = torch.clamp_min(ggx_g1(wi2, p.alpha), 1e-8)
        w_rc = p.spec * F_rc * (ggx_g2(wi2, wo_rc, p.alpha) / g1)[..., None]
        pdf_rc = ggx_vndf_pdf(wi2, m, p.alpha) / torch.clamp_min(
            4.0 * torch.abs(dot(m, wo_rc)), 1e-8)
        put(p.type == T.ROUGH_CONDUCTOR, wo_rc, torch.where(ok[..., None], w_rc, 0.0),
            torch.where(ok, pdf_rc, 0.0), no)

    if has(T.PLASTIC, T.ROUGH_PLASTIC):
        spec_prob, fi_p = _plastic_lobe_probs(p, wi2)
        take_spec = ul < spec_prob

    if has(T.PLASTIC):
        # the delta coat, or the internally scattered diffuse base
        fo_p = fresnel_dielectric(cos_theta(wo_cos), eta_s)
        fdr = _fdr_int(eta_s)
        inv_eta2 = 1.0 / torch.clamp_min(eta_s * eta_s, 1e-8)
        w_pl_diff = (p.refl / torch.clamp_min(1.0 - p.refl * fdr[..., None], 1e-3)
                     * ((1.0 - fi_p) * (1.0 - fo_p) * inv_eta2 / (1.0 - spec_prob))[..., None])
        w_pl_spec = p.spec * (fi_p / spec_prob)[..., None]
        wo_pl = torch.where(take_spec[..., None], wo_mirror, wo_cos)
        w_pl = torch.where(take_spec[..., None], w_pl_spec, w_pl_diff)
        pdf_pl = torch.where(take_spec, spec_prob, (1.0 - spec_prob) * pdf_cos)
        put(p.type == T.PLASTIC, wo_pl, w_pl, pdf_pl, take_spec)

    if has(T.ROUGH_PLASTIC):
        # the GGX coat or the diffuse base, weighted by the mixed pdf
        wo_rp = torch.where(take_spec[..., None], wo_rc, wo_cos)
        f_rp, pdf_rp = _rough_plastic_eval_pdf(p, wi2, wo_rp)
        w_rp = f_rp / torch.clamp_min(pdf_rp, 1e-8)[..., None]
        ok_rp = cos_theta(wo_rp) > 1e-6
        put(p.type == T.ROUGH_PLASTIC, wo_rp, torch.where(ok_rp[..., None], w_rp, 0.0),
            torch.where(ok_rp, pdf_rp, 0.0), no)

    if has(T.PHONG):
        # the cosine lobe or the specular lobe about the mirror direction
        n_ph = _phong_exponent(p)
        take_spec_ph = ul < _spec_lobe_prob(p)
        cos_a = torch.pow(torch.clamp_min(u2[..., 0], 1e-9), 1.0 / (n_ph + 1.0))
        sin_a = safe_sqrt(1.0 - cos_a * cos_a)
        phi = 2.0 * math.pi * u2[..., 1]
        local_lobe = torch.stack([sin_a * torch.cos(phi), sin_a * torch.sin(phi), cos_a], dim=-1)
        wo_ph_spec = Frame.from_normal(reflect_local(wi2)).to_world(local_lobe)
        wo_ph = torch.where(take_spec_ph[..., None], wo_ph_spec, wo_cos)
        f_ph, pdf_ph = _phong_eval_pdf(p, wi2, wo_ph)
        w_ph = f_ph / torch.clamp_min(pdf_ph, 1e-8)[..., None]
        ok_ph = cos_theta(wo_ph) > 0.0
        put(p.type == T.PHONG, wo_ph, torch.where(ok_ph[..., None], w_ph, 0.0), pdf_ph, no)

    if has(T.ROUGH_DIELECTRIC):
        # a visible GGX normal, then Fresnel reflection or refraction,
        # computed with wi in the upper hemisphere as in the eval
        flip_rd = torch.where(cos_theta(wi) >= 0.0, 1.0, -1.0)
        wi_rd = _flip_z(wi, flip_rd)
        m_rd = ggx_sample_vndf(wi_rd, p.alpha, u2)
        eta_rel_rd = torch.where(cos_theta(wi) >= 0.0, eta_s, 1.0 / eta_s)
        wim_rd = dot(wi_rd, m_rd)
        F_rd = fresnel_dielectric(wim_rd, eta_rel_rd)  # 1 under TIR
        take_refl_rd = ul < F_rd
        wo_rd_refl = 2.0 * wim_rd[..., None] * m_rd - wi_rd
        inv_e = 1.0 / eta_rel_rd
        c2 = 1.0 - (1.0 - wim_rd * wim_rd) * inv_e * inv_e
        wo_rd_refr = ((inv_e * wim_rd - safe_sqrt(c2))[..., None] * m_rd
                      - inv_e[..., None] * wi_rd)
        wo_rd_f = normalize(torch.where(take_refl_rd[..., None], wo_rd_refl, wo_rd_refr))
        # a reflection below the horizon or a refraction above it is
        # rejected, as in the reference
        consistent_rd = take_refl_rd == (cos_theta(wo_rd_f) > 0.0)
        wo_rd = _flip_z(wo_rd_f, flip_rd)
        f_rd, pdf_rd = _rough_dielectric_eval_pdf(p, wi, wo_rd)
        w_rd = f_rd / torch.clamp_min(pdf_rd, 1e-8)[..., None]
        ok_rd = consistent_rd & (pdf_rd > 1e-9)
        put(p.type == T.ROUGH_DIELECTRIC, wo_rd, torch.where(ok_rd[..., None], w_rd, 0.0),
            torch.where(ok_rd, pdf_rd, 0.0), no)

    # un-flip wo for the two-sided families (s is 1 for the transmissive)
    return BSDFSample(wo=_flip_z(wo, s), weight=weight, pdf=pdf, is_delta=is_delta)


def _select(cond, a: _P, b: _P) -> _P:
    """Field-wise where(cond, a, b) of two gathered rows' own fields."""
    def sel(x, y):
        return torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())), x, y)

    return _P(*(sel(x, y) for x, y in zip(a[:_P.N_OWN], b[:_P.N_OWN])))


def _coat_sample(p: _P, wi, u2, ul, types, res: BSDFSample) -> BSDFSample:
    """COATING lanes: the coat's reflection with probability R12, else
    refract in, sample the nested lobe, attenuate and refract back out.
    A rough coat's smooth outcomes take the whole coat's eval / pdf as
    their weight.  Overrides ``res`` where the lane is COATING."""
    is_coat = p.type == T.COATING
    pc = _nested(p)[0]
    eta_c = torch.clamp_min(p.eta[..., 0], 1e-3)
    wi2, s = _flip_two_sided(p, wi)
    wi_in, R12 = _coat_refract(wi2, eta_c)
    p_spec = R12
    choose_spec = ul < p_spec
    # the nested lobe with the refracted incident direction
    ul_n = torch.clamp((ul - p_spec) / torch.clamp_min(1.0 - p_spec, 1e-9), 0.0, 1.0 - 1e-7)
    sub = _sample_families(pc, wi_in, u2, ul_n, types)
    wo_in = sub.wo
    sa = p.refl * p.weight[..., None]
    absorb = torch.exp(-sa * (1.0 / torch.clamp_min(torch.abs(wi_in[..., 2]), 1e-6)
                              + 1.0 / torch.clamp_min(torch.abs(wo_in[..., 2]), 1e-6))[..., None])
    wo_out, R21 = _coat_refract(wo_in, 1.0 / eta_c)  # out of the layer
    tir = (R21 >= 1.0) | (R12 >= 1.0)
    inv_eta2 = 1.0 / (eta_c * eta_c)
    czo_in = torch.where(torch.abs(wo_in[..., 2]) < 1e-6, 1e-6, wo_in[..., 2])
    cos_ratio = wo_out[..., 2] / czo_in
    # the measure factors cancel in the weight: the transmittances, the
    # absorption and 1 / (1 - probability of the coat reflection) remain
    w_n = sub.weight * absorb * ((1.0 - R12) * (1.0 - R21)
                                 / torch.clamp_min(1.0 - p_spec, 1e-9))[..., None]
    pdf_n = sub.pdf * (1.0 - p_spec) * torch.where(sub.is_delta, 1.0, inv_eta2 * cos_ratio)
    ok_n = ~tir & (sub.pdf > 0.0)
    # the coat's reflection: a delta mirror, or a GGX visible-normal
    # sample on a rough interface
    rough_c = p.alpha > 1e-3
    m_r = ggx_sample_vndf(wi2, p.alpha, u2)
    wo_ggx = 2.0 * dot(wi2, m_r)[..., None] * m_r - wi2
    wo_spec = torch.where(rough_c[..., None], wo_ggx, reflect_local(wi2))
    wo_c = torch.where(choose_spec[..., None], wo_spec, wo_out)
    f_full, pdf_full = _coating_f_pdf(p, pc, wi2, wo_c, types, p.tcoat)
    smooth_out = rough_c & ~torch.where(choose_spec, False, sub.is_delta)
    ok_r = pdf_full > 1e-9
    w_full = f_full / torch.clamp_min(pdf_full, 1e-9)[..., None]
    w_c = torch.where(choose_spec[..., None], p.spec, torch.where(ok_n[..., None], w_n, 0.0))
    pdf_c = torch.where(choose_spec, torch.clamp_min(p_spec, 1e-9),
                        torch.where(ok_n, pdf_n, 0.0))
    w_c = torch.where(smooth_out[..., None], torch.where(ok_r[..., None], w_full, 0.0), w_c)
    pdf_c = torch.where(smooth_out, torch.where(ok_r, pdf_full, 0.0), pdf_c)
    delta_c = torch.where(choose_spec, ~rough_c, sub.is_delta)
    wo_c = _flip_z(wo_c, s)  # un-flip the two-sided mirror
    return BSDFSample(
        wo=torch.where(is_coat[..., None], wo_c, res.wo),
        weight=torch.where(is_coat[..., None], w_c, res.weight),
        pdf=torch.where(is_coat, pdf_c, res.pdf),
        is_delta=torch.where(is_coat, delta_c, res.is_delta),
    )


def sample_p(p: _P, wi, u, types=PORTED_TYPES) -> BSDFSample:
    """BSDF sampling from gathered parameters; u (N, 3).

    BLEND picks lobe B with probability ``weight``, samples it and
    re-weights a smooth sample by the whole mixture's eval/pdf; a delta
    pick keeps the component's result.  MASK passes straight through
    (delta, weight 1) with probability 1 - opacity, else samples its
    nested lobe; the opacity cancels the same way.  COATING lanes are
    sampled last (``_coat_sample``)."""
    check_types(types)
    u2 = u[..., 0:2]
    ul = u[..., 2]
    if not _has_blend_mask(types):
        res = _sample_families(p, wi, u2, ul, types, p.cloth_aux)
        return _coat_sample(p, wi, u2, ul, types, res) if T.COATING in types else res

    pa, pb = _nested(p)
    is_blend = p.type == T.BLEND
    is_mask = p.type == T.MASK
    w_sel = p.weight
    pick_b = is_blend & (ul < w_sel)
    mask_pass = is_mask & (ul >= w_sel)  # the 1 - opacity pass-through
    use_sub = (is_blend | is_mask) & ~mask_pass
    p_eff = _select(use_sub, _select(pick_b, pb, pa), p)
    # stretch the lobe uniform back to [0, 1) inside the pick
    denom_b = torch.where(pick_b, torch.clamp_min(w_sel, 1e-9),
                          torch.clamp_min(1.0 - w_sel, 1e-9))
    ul_eff = torch.where(
        is_blend,
        torch.clamp(torch.where(pick_b, ul / denom_b, (ul - w_sel) / denom_b), 0.0, 1.0 - 1e-7),
        torch.where(is_mask, torch.clamp(ul / torch.clamp_min(w_sel, 1e-9), 0.0, 1.0 - 1e-7),
                    ul))
    res = _sample_families(p_eff, wi, u2, ul_eff, types, p.cloth_aux)

    wo = torch.where(mask_pass[..., None], -wi, res.wo)
    weight = torch.where(mask_pass[..., None], 1.0, res.weight)
    pdf = torch.where(mask_pass, 1.0 - w_sel, res.pdf)
    is_delta = res.is_delta | mask_pass

    # smooth samples of a nested lobe: the whole mixture's weight
    smooth_sub = use_sub & ~is_delta
    f_mix, pdf_mix = eval_pdf_p(p, wi, wo, types)
    ok = smooth_sub & (pdf_mix > 1e-9)
    weight = torch.where(ok[..., None], f_mix / torch.clamp_min(pdf_mix, 1e-9)[..., None], weight)
    weight = torch.where((smooth_sub & ~ok)[..., None], 0.0, weight)
    pdf = torch.where(smooth_sub, pdf_mix, pdf)
    # delta picks of a nested lobe: the pick probability times the
    # component's own discrete pdf
    delta_sub = use_sub & is_delta
    p_pick = torch.where(is_mask, w_sel, torch.where(pick_b, w_sel, 1.0 - w_sel))
    pdf = torch.where(delta_sub, pdf * p_pick, pdf)
    res = BSDFSample(wo=wo, weight=weight, pdf=pdf, is_delta=is_delta)
    return _coat_sample(p, wi, u2, ul, types, res) if T.COATING in types else res


def eval_pdf(mats: Materials, mid, wi, wo, types=PORTED_TYPES, tex=None, cloth_aux=None):
    return eval_pdf_p(gather_params(mats, mid, tex, types=types, cloth_aux=cloth_aux), wi, wo,
                      types)


def sample(mats: Materials, mid, wi, u, types=PORTED_TYPES, tex=None, cloth_aux=None) -> BSDFSample:
    return sample_p(gather_params(mats, mid, tex, types=types, cloth_aux=cloth_aux), wi, u, types)


def albedo(mats: Materials, mid, types=PORTED_TYPES):
    return albedo_p(gather_params(mats, mid, types=types))


# the reference's unjitted names of the three entry points; eager here
eval_pdf_raw = eval_pdf
sample_raw = sample
albedo_raw = albedo
