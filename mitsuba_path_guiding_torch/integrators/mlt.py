"""Veach path-space MLT with lens, caustic and multi-chain perturbations
(port of the reference's integrators/mlt.py).

Thousands of chains run as wavefront lanes.  A chain's path is a
fixed-depth SoA vertex table (``MLTState``): camera paths that end at
their first emitter hit, without NEE.  Its stationary density is the raw
factor product P = prod (fs cos | F) Le, with no geometry terms except at
a reconnection edge.

One perturbation serves the lens, caustic and multi-chain mutations: pick
an anchor (the lens or a non-specular interior vertex), perturb the image
point (an exponential annulus) or the anchor's outgoing direction (an
exponential cone), re-propagate through the specular chain that follows
with the same lobes, and land on the first non-specular slot j: at the
path's end it must be an emitter; before it, it reconnects to the fixed
vertex j + 1 (a visibility query, and the edge's G ratio in the
acceptance).  Every ``large_every``-th step is a large step, a fresh
forward trace accepted by W' / W.

The steps run as a Python loop whose branch is the step index, a host
int; nothing is read back but the bootstrap's mean once.  Queries route as
``integrators.path.route_dense_or_bvh``: the tiled kernel at 16384
triangles or fewer, else the BVH (the reference's dense oracle has the
tiled kernel's winner).  Shading rows come through ``gather_rows_t``; each
vertex's material row is gathered once and serves both its delta and its
smooth factor.  Rays of lanes whose result is masked off get tmax -1.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.core.math import (
    Frame,
    dot,
    fresnel_conductor,
    fresnel_dielectric,
    normalize,
    reflect_local,
    refract_local,
)
from mitsuba_path_guiding_torch.core.spectrum import luminance
from mitsuba_path_guiding_torch.core.warp import square_to_cosine_hemisphere
from mitsuba_path_guiding_torch.film.film import splat_raw
from mitsuba_path_guiding_torch.integrators.path import INFD, route_dense_or_bvh
from mitsuba_path_guiding_torch.integrators.pssmlt import bootstrap, chain_keys
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import BSDFType, SceneData

P_TRANSMIT_SIDE = 0.1   # the two-sided cosine sampler's transmit-side probability


class MLTState(NamedTuple):
    """SoA chain state; V = the most surface vertices."""

    vp: torch.Tensor     # (V + 1, 3, N) positions; row 0 the camera
    ns: torch.Tensor     # (V, 3, N) shading normals
    ng: torch.Tensor     # (V, 3, N) geometric normals
    prim: torch.Tensor   # (V, N) int32 triangle ids (-1 unused)
    spec: torch.Tensor   # (V, N) bool: a delta vertex
    lobe: torch.Tensor   # (V, N) bool: dielectric reflection
    plen: torch.Tensor   # (N,) int32 the emitter vertex's index; 0 a dead chain
    P: torch.Tensor      # (N, 3) raw factor product (stationary density)
    pdffw: torch.Tensor  # (N,) forward-sampling density (large steps)
    xy: torch.Tensor     # (N, 2) film position


class Statics(NamedTuple):
    """Host reads of a scene made once a render, and its queries."""

    em_kinds: tuple
    mat_types: tuple
    sensor_kind: int
    intersect: object    # (o, d, tmax) -> Hit
    occluded: object     # (o, d, tmax) -> bool


def scene_statics(scene: SceneData, cfg) -> Statics:
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    intersect, occluded = route_dense_or_bvh(scene, cfg.accel)
    return Statics(kinds_present(scene.emitters), types_present(scene.mats),
                   int(scene.sensor.kind), intersect, occluded)


def _shade_rows(geo, prim):
    """(mid, eid as float, ns_at(u, v), ng) of the hits' shading rows, one
    gather (``Geometry.shade_packed``)."""
    row = gather_rows_t(geo.shade_packed, torch.clamp_min(prim, 0))
    ng = torch.stack([row[0], row[1], row[2]], dim=-1)
    mid = row[18].to(torch.int32)

    def ns_at(u, v):
        b0 = 1.0 - u - v
        return normalize(torch.stack([
            b0 * row[3] + u * row[6] + v * row[9],
            b0 * row[4] + u * row[7] + v * row[10],
            b0 * row[5] + u * row[8] + v * row[11],
        ], dim=-1))

    return mid, row[19], ns_at, ng


def _is_delta_type(t):
    return ((t == BSDFType.CONDUCTOR) | (t == BSDFType.DIELECTRIC)
            | (t == BSDFType.THINDIELECTRIC))


def _material_types(mats, mid):
    """The BSDF type of each lane's material row (one gather)."""
    return gather_rows_t(mats.packed, mid)[0].to(torch.int32)


def _spec_propagate(p, wi_l, lobe):
    """A delta interaction with its lobe from ``lobe`` (the retrace must
    follow the same lobes): (wo_l, factor (N, 3), lobe pdf, ok)."""
    cz = wi_l[..., 2]
    # conductor
    f_c = fresnel_conductor(cz, p.eta, p.k)
    wo_c = reflect_local(wi_l)
    fac_c = p.spec * f_c
    # dielectric (signed wi: one-sided physics)
    eta_s = torch.clamp_min(p.eta[..., 0], 1e-3)
    f_d = fresnel_dielectric(cz, eta_s)
    wo_refr, tir = refract_local(wi_l, eta_s)
    rel_eta = torch.where(cz > 0.0, eta_s, 1.0 / eta_s)
    wo_d = torch.where(lobe[..., None], reflect_local(wi_l), wo_refr)
    fac_d = torch.where(
        lobe[..., None],
        p.spec * f_d[..., None],
        p.spec * ((1.0 - f_d) / torch.clamp_min(rel_eta * rel_eta, 1e-8))[..., None])
    pdf_d = torch.where(lobe, f_d, 1.0 - f_d)
    ok_d = lobe | ~tir

    is_diel = p.type == BSDFType.DIELECTRIC
    wo = torch.where(is_diel[..., None], wo_d, wo_c)
    fac = torch.where(is_diel[..., None], fac_d, fac_c)
    pdf = torch.where(is_diel, pdf_d, torch.ones_like(pdf_d))
    ok = torch.where(is_diel, ok_d, torch.ones_like(ok_d))

    # thin dielectric: the reflect lobe with the TIR-summed R' = 2R / (1 + R),
    # else straight through
    f_t = fresnel_dielectric(torch.abs(cz), eta_s)
    rp = torch.where(f_t < 1.0, 2.0 * f_t / (1.0 + f_t), torch.ones_like(f_t))
    wo_t = torch.where(lobe[..., None], reflect_local(wi_l), -wi_l)
    fac_t = p.spec * torch.where(lobe, rp, 1.0 - rp)[..., None]
    is_thin = p.type == BSDFType.THINDIELECTRIC
    wo = torch.where(is_thin[..., None], wo_t, wo)
    fac = torch.where(is_thin[..., None], fac_t, fac)
    pdf = torch.where(is_thin, torch.where(lobe, rp, 1.0 - rp), pdf)
    ok = torch.where(is_thin, lobe | (rp < 1.0), ok)
    return wo, fac, pdf, ok


def _smooth_factor(p, wi_l, wo_l, types):
    """(factor fs cos (N, 3), direction pdf) for the two-sided cosine
    sampler, from the lanes' gathered material parameters."""
    f, _ = bsdf_mod.eval_pdf_p(p, wi_l, wo_l, types)
    same_side = (wi_l[..., 2] * wo_l[..., 2]) > 0.0
    p_side = torch.where(same_side, 1.0 - P_TRANSMIT_SIDE, P_TRANSMIT_SIDE)
    pdf_dir = p_side * torch.abs(wo_l[..., 2]) / math.pi
    return f, torch.clamp_min(pdf_dir, 1e-12)


def _trace_path(scene: SceneData, cfg, u_mat: torch.Tensor, st: Statics) -> MLTState:
    """Forward-trace a wave of paths from primary-sample coordinates
    u_mat (2 + 3V, N): rows 0:2 the screen, then (u1, u2, u_sel) a
    bounce."""
    V = cfg.max_depth
    n = u_mat.shape[1]
    w, h = cfg.width, cfg.height
    dev = u_mat.device
    geo = scene.geo

    fx, fy = u_mat[0] * w, u_mat[1] * h
    ix = torch.clamp(fx.to(torch.int32), 0, w - 1)
    iy = torch.clamp(fy.to(torch.int32), 0, h - 1)
    pid = iy * w + ix
    jitter = torch.stack([fx - ix, fy - iy], dim=-1)
    o, d, film_xy = generate_rays(scene.sensor, w, h, pid, jitter, kind=st.sensor_kind)

    f32 = dict(dtype=torch.float32, device=dev)
    vp = torch.zeros((V + 1, 3, n), **f32)
    vp[0] = o.T
    ns_t = torch.zeros((V, 3, n), **f32)
    ng_t = torch.zeros((V, 3, n), **f32)
    prim_t = torch.full((V, n), -1, dtype=torch.int32, device=dev)
    spec_t = torch.zeros((V, n), dtype=torch.bool, device=dev)
    lobe_t = torch.zeros((V, n), dtype=torch.bool, device=dev)
    plen = torch.zeros((n,), dtype=torch.int32, device=dev)
    P = torch.ones((n, 3), **f32)
    pdffw = torch.ones((n,), **f32)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)

    for i in range(1, V + 1):
        hit = st.intersect(o, d, torch.where(alive, INFD, -1.0))
        valid = alive & hit.valid
        p = o + torch.where(hit.valid, hit.t, 1.0)[..., None] * d
        mid, eid_f, ns_at, ng = _shade_rows(geo, hit.prim)
        ns = ns_at(hit.u, hit.v)
        ns = torch.where(dot(ns, ng)[..., None] < 0.0, -ns, ns)
        is_em = valid & (eid_f >= 0.0)
        le = em_mod.eval_hit(scene.emitters, geo, eid_f.to(torch.int32), d, hit.prim)
        P = torch.where(is_em[..., None], P * le, P)
        plen = torch.where(is_em, i, plen)

        vp[i] = torch.where(valid, p.T, vp[i])
        ns_t[i - 1] = torch.where(valid, ns.T, ns_t[i - 1])
        ng_t[i - 1] = torch.where(valid, ng.T, ng_t[i - 1])
        prim_t[i - 1] = torch.where(valid, hit.prim, prim_t[i - 1])
        if i == V:
            break

        params = bsdf_mod.gather_params(scene.mats, mid, types=st.mat_types)
        is_spec = _is_delta_type(params.type)
        fr = Frame.from_normal(ns)
        wi_l = fr.to_local(-d)
        u1, u2, usel = u_mat[2 + 3 * (i - 1)], u_mat[3 + 3 * (i - 1)], u_mat[4 + 3 * (i - 1)]

        lobe = usel < fresnel_dielectric(wi_l[..., 2], torch.clamp_min(params.eta[..., 0], 1e-3))
        wo_s, fac_s, pdf_s, ok_s = _spec_propagate(params, wi_l, lobe)

        wo_cos = square_to_cosine_hemisphere(torch.stack([u1, u2], dim=-1))
        side = torch.where(usel < P_TRANSMIT_SIDE, -1.0, 1.0)
        sgn = torch.sign(torch.where(wi_l[..., 2] == 0.0, 1.0, wi_l[..., 2]))
        wo_d = wo_cos * torch.stack([torch.ones_like(side), torch.ones_like(side), side * sgn],
                                    dim=-1)
        fac_d, pdf_d = _smooth_factor(params, wi_l, wo_d, st.mat_types)

        wo_l = torch.where(is_spec[..., None], wo_s, wo_d)
        fac = torch.where(is_spec[..., None], fac_s, fac_d)
        pdfstep = torch.where(is_spec, pdf_s, pdf_d)
        ok = torch.where(is_spec, ok_s, torch.ones_like(ok_s))

        cont = valid & ~is_em & ok
        P = torch.where(cont[..., None], P * fac, P)
        pdffw = torch.where(cont, pdffw * torch.clamp_min(pdfstep, 1e-12), pdffw)
        spec_t[i - 1] = torch.where(cont, is_spec, spec_t[i - 1])
        lobe_t[i - 1] = torch.where(cont, lobe, lobe_t[i - 1])
        alive = cont & (luminance(P) > 0.0)
        o = torch.where(cont[..., None], p, o)
        d = torch.where(cont[..., None], fr.to_world(wo_l), d)

    P = torch.where((plen == 0)[..., None], 0.0, P)
    return MLTState(vp, ns_t, ng_t, prim_t, spec_t, lobe_t, plen, P,
                    torch.clamp_min(pdffw, 1e-30), film_xy)


def _eval_chain(scene: SceneData, s: MLTState, cfg, st: Statics):
    """(P, pdffw) recomputed from the vertex table: the one source of
    truth of a proposal."""
    V = cfg.max_depth
    n = s.plen.shape[0]
    dev = s.P.device
    P = torch.ones((n, 3), dtype=torch.float32, device=dev)
    pdffw = torch.ones((n,), dtype=torch.float32, device=dev)
    for i in range(1, V + 1):
        on_path = i <= s.plen
        win = normalize(s.vp[i].T - s.vp[i - 1].T)
        prim = s.prim[i - 1]
        mid, eid_f, _, _ = _shade_rows(scene.geo, prim)
        at_end = on_path & (i == s.plen)
        le = em_mod.eval_hit(scene.emitters, scene.geo, eid_f.to(torch.int32), win, prim)
        P = torch.where(at_end[..., None], P * le, P)

        interior = on_path & (i < s.plen)
        if i == V:
            break
        wout = normalize(s.vp[i + 1].T - s.vp[i].T)
        fr = Frame.from_normal(s.ns[i - 1].T)
        wi_l = fr.to_local(-win)
        wo_l = fr.to_local(wout)
        params = bsdf_mod.gather_params(scene.mats, mid, types=st.mat_types)
        _, fac_s, pdf_s, _ = _spec_propagate(params, wi_l, s.lobe[i - 1])
        fac_d, pdf_d = _smooth_factor(params, wi_l, wo_l, st.mat_types)
        is_spec = s.spec[i - 1]
        fac = torch.where(is_spec[..., None], fac_s, fac_d)
        pstep = torch.where(is_spec, pdf_s, pdf_d)
        P = torch.where(interior[..., None], P * fac, P)
        pdffw = torch.where(interior, pdffw * torch.clamp_min(pstep, 1e-12), pdffw)
    P = torch.where((s.plen == 0)[..., None], 0.0, P)
    return P, torch.clamp_min(pdffw, 1e-30)


def _rotate_about(d, theta, phi):
    """Rotate unit d by theta toward azimuth phi in d's tangent frame (the
    caustic perturbation's cone)."""
    local = torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                         torch.cos(theta)], dim=-1)
    return Frame.from_normal(d).to_world(local)


def _vertex_at(vp, idx):
    """(N, 3) positions of each lane's vertex idx (N,) in vp (V + 1, 3, N)."""
    n = vp.shape[2]
    ix = idx.to(torch.int64)[None, None, :].expand(1, 3, n)
    return torch.gather(vp, 0, ix)[0].T


def _first_true(mask):
    """Index of the first True along axis 0 of a (V, N) bool mask (0 where
    none)."""
    return torch.argmax(mask.to(torch.int32), dim=0).to(torch.int32)


def _perturb(scene: SceneData, cfg, st: Statics, s: MLTState, u: torch.Tensor):
    """The unified lens / caustic / multi-chain perturbation of every
    chain; u (9, N) uniforms.  Returns (proposal MLTState, G ratio (N,),
    valid (N,))."""
    V = cfg.max_depth
    w, h = cfg.width, cfg.height
    n = s.plen.shape[0]
    dev = u.device
    geo = scene.geo
    vi = torch.arange(V, dtype=torch.int32, device=dev)[:, None]   # (V, 1)

    # the anchor: uniform over {lens} and the non-specular interior vertices
    interior_ok = (vi + 1 < s.plen[None, :]) & ~s.spec             # (V, N)
    n_anchor = 1 + interior_ok.to(torch.int32).sum(dim=0, dtype=torch.int32)
    pick = (u[0] * n_anchor).to(torch.int32)                        # 0 = the lens
    csum = torch.cumsum(interior_ok.to(torch.int32), dim=0, dtype=torch.int32)
    m_idx = _first_true((csum == pick[None, :]) & interior_ok) + 1
    is_lens = pick == 0
    anchor = torch.where(is_lens, 0, m_idx)

    # the specular chain after the anchor ends at the first non-specular
    # slot j > anchor (j == plen: the endpoint, caustic mode)
    after = vi + 1 > anchor[None, :]
    nonspec_slot = after & ~s.spec & (vi + 1 <= s.plen[None, :])
    has_j = nonspec_slot.any(dim=0)
    j = torch.where(has_j, _first_true(nonspec_slot) + 1, s.plen)

    # the lens: an exponential annulus in screen space
    r1, r2 = 0.25, 0.05 * min(w, h)
    rr = r2 * torch.exp(-math.log(r2 / r1) * u[1])
    phi = 2.0 * math.pi * u[2]
    s_new = s.xy + rr[..., None] * torch.stack([torch.cos(phi), torch.sin(phi)], dim=-1)
    in_img = ((s_new[:, 0] >= 0) & (s_new[:, 0] < w) & (s_new[:, 1] >= 0)
              & (s_new[:, 1] < h))
    sx = torch.clamp(s_new[:, 0], 0.0, w - 1e-3)
    sy = torch.clamp(s_new[:, 1], 0.0, h - 1e-3)
    pid = sy.to(torch.int32) * w + sx.to(torch.int32)
    jit = torch.stack([sx - torch.floor(sx), sy - torch.floor(sy)], dim=-1)
    o_l, d_l, xy_l = generate_rays(scene.sensor, w, h, pid, jit, kind=st.sensor_kind)
    # an interior anchor: an exponential cone about its outgoing direction
    th1, th2 = 0.0001, 0.1
    theta = th2 * torch.exp(-math.log(th2 / th1) * u[3])
    av = _vertex_at(s.vp, anchor)
    d_old = normalize(_vertex_at(s.vp, anchor + 1) - av)
    d_c = _rotate_about(d_old, theta, 2.0 * math.pi * u[4])

    o = torch.where(is_lens[..., None], o_l, av)
    d = torch.where(is_lens[..., None], d_l, d_c)
    xy_new = torch.where(is_lens[..., None], xy_l, s.xy)
    ok = torch.where(is_lens, in_img, torch.ones_like(in_img))
    ok = ok & (s.plen > 0)

    # the old types along the path (the chain slots must keep them)
    old_mid, _, _, _ = _shade_rows(geo, s.prim.reshape(-1))
    old_type = _material_types(scene.mats, old_mid).reshape(V, n)

    # re-propagate slots anchor + 1 .. j
    vp_n, ns_n, ng_n, prim_n = s.vp.clone(), s.ns.clone(), s.ng.clone(), s.prim.clone()
    j_pos = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    j_mid = torch.zeros((n,), dtype=torch.int32, device=dev)
    j_eid = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    for i in range(1, V + 1):
        act = ok & (i > anchor) & (i <= j)
        hit = st.intersect(o, d, torch.where(act, INFD, -1.0))
        p = o + torch.where(hit.valid, hit.t, 1.0)[..., None] * d
        mid, eid_f, ns_at, ng = _shade_rows(geo, hit.prim)
        ns = ns_at(hit.u, hit.v)
        ns = torch.where(dot(ns, ng)[..., None] < 0.0, -ns, ns)
        params = bsdf_mod.gather_params(scene.mats, mid, types=st.mat_types)
        new_spec = _is_delta_type(params.type)

        in_chain = act & (i < j)
        at_j = act & (i == j)
        # chain slots keep their delta type; slot j must be hit (its kind
        # is checked below)
        ok = ok & (~in_chain | (hit.valid & new_spec & (params.type == old_type[i - 1])))
        ok = ok & (~at_j | hit.valid)

        upd = in_chain | at_j
        vp_n[i] = torch.where(upd, p.T, vp_n[i])
        ns_n[i - 1] = torch.where(upd, ns.T, ns_n[i - 1])
        ng_n[i - 1] = torch.where(upd, ng.T, ng_n[i - 1])
        prim_n[i - 1] = torch.where(upd, hit.prim, prim_n[i - 1])
        j_pos = torch.where(at_j[..., None], p, j_pos)
        j_mid = torch.where(at_j, mid, j_mid)
        j_eid = torch.where(at_j, eid_f, j_eid)

        # the chain slots' deterministic delta propagation
        fr = Frame.from_normal(ns)
        wo_s, _, _, ok_prop = _spec_propagate(params, fr.to_local(-d), s.lobe[i - 1])
        ok = ok & (~in_chain | ok_prop)
        o = torch.where(in_chain[..., None], p, o)
        d = torch.where(in_chain[..., None], fr.to_world(wo_s), d)

    endpoint = j == s.plen
    # endpoint mode: slot j is an emitter; reconnection: a non-specular,
    # non-emissive surface that sees the suffix vertex
    j_delta = _is_delta_type(_material_types(scene.mats, j_mid))
    ok = ok & torch.where(endpoint, j_eid >= 0.0, (j_eid < 0.0) & ~j_delta)
    vj1 = _vertex_at(s.vp, torch.clamp_max(j + 1, V))
    to_suf = vj1 - j_pos
    rlen = torch.sqrt(torch.clamp_min(dot(to_suf, to_suf), 1e-12))
    sdir = to_suf / rlen[..., None]
    occ = st.occluded(j_pos + 1e-4 * sdir, sdir, torch.where(ok & ~endpoint, rlen - 2e-4, -1.0))
    ok = ok & (endpoint | ~occ)

    # the reconnection edge's G ratio (only the suffix side's cosine: the
    # moving vertex j's cosine is inside P already)
    old_jpos = _vertex_at(s.vp, j)
    suf_prim = torch.gather(s.prim, 0, torch.clamp_max(j, V - 1).to(torch.int64)[None, :])[0]
    _, _, _, suf_ng = _shade_rows(geo, suf_prim)

    def edge_g(a, b, nb):
        v = b - a
        r2_ = torch.clamp_min(dot(v, v), 1e-12)
        dn = v / torch.sqrt(r2_)[..., None]
        return torch.abs(dot(nb, dn)) / r2_

    g_new = edge_g(j_pos, vj1, suf_ng)
    g_old = edge_g(old_jpos, vj1, suf_ng)
    g_ratio = torch.where(endpoint, 1.0, g_new / torch.clamp_min(g_old, 1e-20))

    prop = MLTState(vp_n, ns_n, ng_n, prim_n, s.spec, s.lobe, s.plen, s.P, s.pdffw, xy_new)
    return prop, g_ratio, ok


def _splat_both(acc, s: MLTState, xy_p, P_p, a, width: int, height: int):
    i_cur = torch.clamp_min(luminance(s.P), 1e-12)
    i_p = torch.clamp_min(luminance(P_p), 1e-12)
    splat_raw(acc, s.xy, s.P * ((1.0 - a) / i_cur)[..., None], width, height)
    splat_raw(acc, xy_p, P_p * (a / i_p)[..., None], width, height)


def _large_step(scene, cfg, st: Statics, s: MLTState, k, acc):
    dims = 2 + 3 * cfg.max_depth
    u = rng.uniform(k, dims + 1).T
    prop = _trace_path(scene, cfg, u[:dims], st)
    w_cur = luminance(s.P) / s.pdffw
    w_p = luminance(prop.P) / prop.pdffw
    a = torch.clamp(w_p / torch.clamp_min(w_cur, 1e-30), 0.0, 1.0)
    _splat_both(acc, s, prop.xy, prop.P, a, cfg.width, cfg.height)
    take = u[dims] < a
    return MLTState(*(_select_field(f, take, pn, po) for f, pn, po in
                      zip(MLTState._fields, prop, s)))


def _select_field(field, take, new, old):
    """One MLTState field of the accepted chains' proposals: the tables
    carry the chain axis last, P, pdffw and xy first."""
    if field in ("vp", "ns", "ng"):
        return torch.where(take[None, None, :], new, old)
    if field in ("prim", "spec", "lobe"):
        return torch.where(take[None, :], new, old)
    if field in ("P", "xy"):
        return torch.where(take[..., None], new, old)
    return torch.where(take, new, old)


def _pert_step(scene, cfg, st: Statics, s: MLTState, k, acc):
    u = rng.uniform(k, 9).T
    prop, g_ratio, okv = _perturb(scene, cfg, st, s, u)
    P_p, pdffw_p = _eval_chain(scene, prop, cfg, st)
    lum_p = luminance(P_p)
    a = torch.clamp(lum_p / torch.clamp_min(luminance(s.P), 1e-30) * g_ratio, 0.0, 1.0)
    a = torch.where(okv & (lum_p > 0.0), a, 0.0)
    _splat_both(acc, s, prop.xy, P_p, a, cfg.width, cfg.height)
    take = u[8] < a
    prop = prop._replace(P=P_p, pdffw=pdffw_p)
    return MLTState(*(old if f in ("spec", "lobe", "plen") else _select_field(f, take, new, old)
                      for f, new, old in zip(MLTState._fields, prop, s)))


def _chain_steps(scene, cfg, st: Statics, s: MLTState, keys, step0: int, acc, n_steps: int,
                 large_every: int = 4):
    """n_steps mutations of every chain from step index step0: a large
    step at every ``large_every``-th index, perturbations otherwise."""
    for i in range(n_steps):
        k = rng.fold_in(keys, step0 + i)
        step = _large_step if (step0 + i) % large_every == 0 else _pert_step
        s = step(scene, cfg, st, s, k, acc)
    return s


def render_mlt(scene: SceneData, cfg, n_chains: int = 4096,
               mutations_per_pixel: int | None = None, bootstrap_factor: int = 4,
               large_every: int = 4):
    """Path-space MLT render: bootstrap, seed the chains in proportion to
    the path weight, mutate and splat.  Returns (H, W, 3) on the scene's
    device."""
    dev = resolve_device(scene.geo.p0.device)
    w, h = cfg.width, cfg.height
    st = scene_statics(scene, cfg)
    dims = 2 + 3 * cfg.max_depth
    mpp = mutations_per_pixel or cfg.spp
    n_steps_total = max(w * h * mpp // n_chains, 1)

    kb, kseed, kchain = rng.split(rng.base_key(cfg.seed, device=dev), 3)

    def f_eval(u):
        boot = _trace_path(scene, cfg, u, st)
        return luminance(boot.P) / boot.pdffw, boot

    b, idx, _, boot = bootstrap((kb, kseed), dims, bootstrap_factor * n_chains, n_chains,
                                f_eval)
    if b <= 0.0:
        return torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    s = MLTState(*(x[..., idx] if f in ("vp", "ns", "ng", "prim", "spec", "lobe") else x[idx]
                   for f, x in zip(MLTState._fields, boot)))
    acc = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    _chain_steps(scene, cfg, st, s, chain_keys(kchain, n_chains), 0, acc, n_steps_total,
                 large_every)
    n_samples = n_steps_total * n_chains
    return acc.reshape(h, w, 3) * (b * (w * h) / n_samples)
