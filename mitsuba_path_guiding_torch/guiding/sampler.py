"""Guided directional sampling: one-sample MIS between the BSDF and the
guiding mixture (port of the reference's guiding/sampler.py
``make_guide_fn``).

With probability ``alpha * alpha_scale`` a direction is drawn from the
cell's vMF mixture, else from the BSDF; the estimator divides by the
combined density, which keeps it unbiased for any cache contents.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from mitsuba_path_guiding_torch.guiding.grid import (
    MAX_REFINE_LEVELS,
    GuidingGrid,
    _gather_cells,
    _mixture_pdf,
    _mixture_sample,
    cell_index,
    parallax_params,
    product_params,
)
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.scene.types import BSDFType


def _is_delta(p_type: torch.Tensor) -> torch.Tensor:
    return ((p_type == BSDFType.CONDUCTOR) | (p_type == BSDFType.DIELECTRIC)
            | (p_type == BSDFType.NULL) | (p_type == BSDFType.THINDIELECTRIC))


@lru_cache(maxsize=64)
def make_guide_fn(alpha: float = 0.5, mat_types=bsdf_mod.PORTED_TYPES, product: bool = False,
                  levels: int | None = None, parallax: bool = False, min_rough: float = 0.0):
    """The ``guide`` callback consumed by integrators.path.trace.  Cached,
    so identical configurations return the same function object.

    ``levels`` is the octree walk depth of ``cell_index`` (None: the
    deepest, ``MAX_REFINE_LEVELS``; 0 for a grid that was never refined).
    ``parallax`` re-aims each lobe at its virtual source from the shading
    point; ``product`` then multiplies the mixture by a cosine lobe about
    the shading normal.  ``min_rough`` > 0 guides only the diffuse-class
    families (DIFFUSE, ROUGH_DIFFUSE, DIFFTRANS, CLOTH) and materials at
    least that rough (the raw ``alpha`` column): a coarse cache cannot
    out-sample a narrow BSDF lobe.

    The callback and its ``pdf_at`` take an optional ``params``: the lane's
    material row from ``bsdf.gather_params``, gathered once per bounce by
    the caller (with the texture and the cloth record applied); without
    it they gather it themselves, the callback with its ``tex`` and
    ``cloth_aux``."""
    bsdf_mod.check_types(mat_types)
    walk = MAX_REFINE_LEVELS if levels is None else levels

    def _params_and_alpha(grid: GuidingGrid, mats, mid, p, frame, mp):
        cid = cell_index(grid, p, levels=walk)
        params, a_scale = _gather_cells(grid, cid, with_alpha=True)
        if parallax:
            params = parallax_params(grid, cid, params, p)
        if product:
            params = product_params(params, frame.n)
        usable = params[-1] & ~_is_delta(mp.type)
        if min_rough > 0.0:
            diffuseish = ((mp.type == BSDFType.DIFFUSE) | (mp.type == BSDFType.ROUGH_DIFFUSE)
                          | (mp.type == BSDFType.DIFFTRANS) | (mp.type == BSDFType.CLOTH))
            usable = usable & (diffuseish | (mats.alpha[mid.long()] >= min_rough))
        return params, torch.where(usable, alpha * a_scale, 0.0)

    def guide(grid: GuidingGrid, mats, mid, p, frame, wi_local, u3, u_sel,
              u_lobe, tex=None, cloth_aux=None, params=None):
        mp = (bsdf_mod.gather_params(mats, mid, tex, types=mat_types, cloth_aux=cloth_aux)
              if params is None else params)
        gparams, a = _params_and_alpha(grid, mats, mid, p, frame, mp)
        bs = bsdf_mod.sample_p(mp, wi_local, u3, types=mat_types)
        d_guided = _mixture_sample(gparams, u_lobe, u3[..., 0:2])
        wo_guided = frame.to_local(d_guided)
        take_guide = (u_sel < a) & ~bs.is_delta
        wo_local = torch.where(take_guide[..., None], wo_guided, bs.wo)
        wo_world = frame.to_world(wo_local)
        f, pdf_b = bsdf_mod.eval_pdf_p(mp, wi_local, wo_local, types=mat_types)
        pdf_g = _mixture_pdf(gparams, wo_world)
        pdf_comb = a * pdf_g + (1.0 - a) * pdf_b
        w_smooth = f / torch.clamp_min(pdf_comb, 1e-8)[..., None]
        ok = pdf_comb > 1e-9
        native = bs.is_delta | (a <= 0.0)
        weight = torch.where(native[..., None], bs.weight,
                             torch.where(ok[..., None], w_smooth, 0.0))
        pdf = torch.where(native, bs.pdf, pdf_comb)
        return wo_world, pdf, weight, bs.is_delta

    def pdf_at(grid: GuidingGrid, mats, mid, p, frame, dir_world, pdf_bsdf, params=None):
        """Density the guided strategy gives an arbitrary direction (the
        density NEE's MIS weight must use)."""
        mp = bsdf_mod.gather_params(mats, mid, types=mat_types) if params is None else params
        gparams, a = _params_and_alpha(grid, mats, mid, p, frame, mp)
        return a * _mixture_pdf(gparams, dir_world) + (1.0 - a) * pdf_bsdf

    guide.alpha = alpha
    guide.pdf_at = pdf_at
    return guide
