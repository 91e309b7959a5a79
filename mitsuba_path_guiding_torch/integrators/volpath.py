"""Volumetric wavefront path tracer: one global medium, homogeneous or a
density grid, with every phase family (port of the reference's
integrators/volpath.py ``trace_vol``).

  - Homogeneous media: closed-form transmittance and per-channel
    exponential distance sampling combined by the balance heuristic;
    microflake media have a directional extinction.
  - Grid media: weighted delta tracking for the free flight and ratio
    tracking for shadow rays (``models/medium.py``).
  - Guided distance sampling (``guiding/distance.py``): one-sample MIS of
    a radiance-weighted piecewise density against the analytic sampler
    (homogeneous), or that density with grid optical depth and a
    ratio-tracked weight (grids).
  - NEE from medium and surface events with attenuated visibility,
    phase sampling (guided: one-sample MIS with the vMF mixture), Russian
    roulette, straight pass-throughs and ``PathRecord``s of both event
    types for the fit.

The structure is ``integrators/path.py``'s: a Python loop over a fixed
depth of SoA tensors with alive masks, one uniform block a bounce, the
shading row of every hit through ``ops.gather.gather_rows_t``.  Queries
route as ``trace``'s do: "auto" takes the tiled intersector at 16384
triangles or fewer and the BVH above, "bvh" the BVH and "brute" the dense
oracle, for shadow rays too; NULL or MASK scenes march shadow rays with
the wave's closest-hit query.  Textures and bump maps are not applied
and CLOTH rows shade with their uv-averaged Ward fit, as in the
reference, whose ``trace_vol`` fetches no texture either.
"""
from __future__ import annotations

import torch

from mitsuba_path_guiding_torch.accel.traverse import shadow_transmittance
from mitsuba_path_guiding_torch.core.math import Frame, dot, normalize, power_heuristic
from mitsuba_path_guiding_torch.core.rng import bounce_uniform
from mitsuba_path_guiding_torch.core.spectrum import luminance
from mitsuba_path_guiding_torch.guiding.distance import (
    cell_flux,
    guided_distance_weights,
    guided_distance_weights_hetero,
    piecewise_pdf,
    piecewise_sample,
)
from mitsuba_path_guiding_torch.guiding.grid import (
    _gather_cells,
    _mixture_pdf,
    _mixture_sample,
    cell_index,
)
from mitsuba_path_guiding_torch.integrators.path import (
    INFD,
    PathAux,
    PathRecord,
    _offset_ray,
    route_dense_or_bvh,
)
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.medium import (
    _track_keys,
    density_at,
    sample_free_flight,
    transmittance_ratio,
)
from mitsuba_path_guiding_torch.models.phase import (
    PhaseKind,
    _mf_sigma_t,
    phase_eval_kind,
    phase_sample_kind_w,
)
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import BSDFType, SceneData

# key salts of the tracking loops (apart from the bounce tags)
TAG_TRACK_DIST = 2 << 20
TAG_TRACK_NEE = 3 << 20


def transmittance(sigma_t: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """(N,) distances -> (N, 3) closed-form homogeneous transmittance;
    ``sigma_t`` (3,) or per lane (N, 3)."""
    d = torch.clamp_max(dist, 1e7)  # exp(-sigma inf) underflow guard
    st = sigma_t if sigma_t.dim() > 1 else sigma_t[None, :]
    return torch.exp(-st * d[..., None])


def _distance_pdfs(sigma_t: torch.Tensor, t: torch.Tensor):
    """(pdf of a medium event at t, probability of passing t) of the
    per-channel exponential samplers under equal channel weights."""
    st = sigma_t if sigma_t.dim() > 1 else sigma_t[None, :]
    ex = torch.exp(-st * torch.clamp_max(t, 1e7)[..., None])
    return torch.mean(st * ex, dim=-1), torch.mean(ex, dim=-1)


def trace_vol(
    scene: SceneData,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    rkeys: torch.Tensor,
    max_depth: int = 8,
    rr_depth: int = 8,
    use_nee: bool = True,
    use_bvh: bool = False,
    guide=None,
    guide_state=None,
    em_kinds=em_mod.PORTED_KINDS,
    mat_types=bsdf_mod.PORTED_TYPES,
    record_paths: bool = False,
    hetero: bool = False,
    phase_kind: int = 0,
    guide_distance: bool = False,
    accel: str = "auto",
):
    """Returns (L (N, 3), PathAux, PathRecord | None).  ``max_depth``
    counts collisions, surface or medium; the records hold both event
    types, so the guiding cache trains on volumetric transport too."""
    n = ray_o.shape[0]
    bsdf_mod.check_types(mat_types)
    dev = ray_o.device
    geo, mats, em, med = scene.geo, scene.mats, scene.emitters, scene.medium
    sigma_t = med.sigma_a + med.sigma_s
    sigma_s = med.sigma_s
    g_hg = med.phase_g

    intersect, occluded = route_dense_or_bvh(scene, accel, use_bvh)

    # microflake media have a directional extinction: sigma_t(w) scales
    # with the flakes' projected area along w, normalised by its mean over
    # directions (phase_aux[3]) so that sigma_a and sigma_s keep their mean
    directional = (phase_kind == PhaseKind.MICROFLAKE and not hetero
                   and med.sigt_table is not None)

    def dir_factor(w):
        cosw = torch.abs(dot(w, torch.broadcast_to(med.orientation, w.shape)))
        return _mf_sigma_t(med.sigt_table, cosw) / torch.clamp_min(med.phase_aux[3], 1e-9)

    transparent = BSDFType.NULL in mat_types or BSDFType.MASK in mat_types

    def vis_transmittance(o, d, dist, depth):
        """Attenuated visibility of shadow rays: the surfaces' term
        (transparency-aware with null or mask materials) times the
        medium's transmittance (closed form, or ratio tracking in a grid)."""
        if transparent:
            vis = shadow_transmittance(geo, mats.packed, o, d, dist, intersect)[..., None]
        else:
            vis = (~occluded(o, d, dist))[..., None].to(torch.float32)
        if hetero:
            tr = transmittance_ratio(med, o, d, dist, _track_keys(rkeys, depth, TAG_TRACK_NEE))
        elif directional:
            tr = transmittance(sigma_t[None, :] * dir_factor(d)[..., None], dist)
        else:
            tr = transmittance(sigma_t, dist)
        return vis * tr

    f32 = dict(dtype=torch.float32, device=dev)
    o, d = ray_o, ray_d
    L = torch.zeros((n, 3), **f32)
    T = torch.ones((n, 3), **f32)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.full((n,), INFD, **f32)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    t_acc = torch.zeros((n,), **f32)
    aux = PathAux(
        albedo=torch.zeros((n, 3), **f32),
        normal=torch.zeros((n, 3), **f32),
        depth_t=torch.zeros((n,), **f32),
        n_bounces=torch.zeros((n,), dtype=torch.int32, device=dev),
        first_le=torch.zeros((n, 3), **f32),
    )
    recs = []

    # guided distance sampling: a per-cell flux from the fitted cache,
    # once a wave (not with the microflake's directional extinction)
    use_guided_dist = (guide_distance and guide is not None and not hetero
                       and phase_kind != PhaseKind.MICROFLAKE)
    use_guided_dist_het = (guide_distance and guide is not None and hetero
                           and phase_kind != PhaseKind.MICROFLAKE)
    if use_guided_dist or use_guided_dist_het:
        dist_flux = cell_flux(guide_state)

    # uniforms per bounce: 0:3 NEE, 3:6 phase or BSDF, 6 guide selection,
    # 7 guide lobe, 8 roulette, 9 channel, 10 distance, 11 guided distance
    for depth in range(max_depth):
        u = bounce_uniform(rkeys, depth, 12)
        hit = intersect(o, d, torch.where(alive, INFD, -1.0))
        t_surf = torch.where(hit.valid, hit.t, INFD)

        if hetero:
            # weighted delta tracking against the grid's majorant (dead
            # lanes track an empty span)
            t_max = torch.where(alive, t_surf, -1.0)
            t_med, is_med_ev, w_ff = sample_free_flight(
                med, o, d, t_max, _track_keys(rkeys, depth, TAG_TRACK_DIST))
            if use_guided_dist_het:
                # the collision distance from the radiance-weighted density
                # with grid optical depth, the surface taken with
                # probability ~ Tr(t_surf), the weight from an unbiased
                # ratio-tracked transmittance; lanes whose cache is cold
                # keep the tracker's result
                t1 = torch.minimum(t_surf, torch.amax(scene.aabb_max - scene.aabb_min) * 1.74)
                w_seg, dt_seg, tot_seg, tr_end = guided_distance_weights_hetero(
                    guide_state, dist_flux, med, o, d, t1)
                m_cont = tot_seg * dt_seg
                ok_g = (m_cont > 1e-10) & (dt_seg > 1e-9)
                p_surf = torch.clamp(tr_end, 0.05, 0.95)
                go_surf = u[..., 11] < p_surf
                t_g = piecewise_sample(w_seg, dt_seg, tot_seg, u[..., 10])
                pdf_c = piecewise_pdf(w_seg, dt_seg, tot_seg, t_g)
                t_ev = torch.where(go_surf, torch.minimum(t_surf, t1 * 4.0), t_g)
                tr_hat = transmittance_ratio(med, o, d, torch.where(alive, t_ev, -1.0),
                                             _track_keys(rkeys, depth, TAG_TRACK_DIST + 7))
                x_ev = o + t_g[..., None] * d
                ss_ev = density_at(med, x_ev)[..., None] * med.sigma_s
                w_med_g = ss_ev * tr_hat / torch.clamp_min(
                    ((1.0 - p_surf) * pdf_c)[..., None], 1e-30)
                w_srf_g = tr_hat / p_surf[..., None]
                t_med = torch.where(ok_g, torch.where(go_surf, INFD, t_g), t_med)
                is_med_ev = torch.where(ok_g, ~go_surf, is_med_ev)
                w_ff = torch.where(ok_g[..., None],
                                   torch.where(go_surf[..., None], w_srf_g, w_med_g), w_ff)
            is_medium = alive & is_med_ev
            is_surface = alive & hit.valid & ~is_medium
            escaped = alive & ~hit.valid & ~is_medium
            # w_ff holds sigma_s / (majorant P_real) on medium events and
            # the null ratios on pass-through
            T = torch.where((is_medium | is_surface | escaped)[..., None], T * w_ff, T)
        else:
            # a channel picked uniformly, its exponential CDF inverted
            ch = torch.clamp((u[..., 9] * 3.0).to(torch.int64), 0, 2)
            if directional:
                fac = dir_factor(d)[..., None]
                st_eff = sigma_t[None, :] * fac
                ss_eff = sigma_s[None, :] * fac
                st_ch = torch.clamp_min(torch.take_along_dim(st_eff, ch[:, None], dim=1)[:, 0],
                                        1e-12)
            else:
                st_eff, ss_eff = sigma_t, sigma_s[None, :]
                st_ch = torch.clamp_min(sigma_t[ch], 1e-12)
            t_med = -torch.log(torch.clamp_min(1.0 - u[..., 10], 1e-12)) / st_ch
            medium_on = torch.amax(sigma_t) > 0.0
            t_med = torch.where(medium_on, t_med, INFD)

            if use_guided_dist:
                # one-sample MIS of the analytic sampler above with the
                # radiance-weighted piecewise density; the analytic part
                # keeps full support, so a cold cache leaves no bias
                sigma_bar = torch.mean(sigma_t)
                # the guided range ends where Tr ~ 1e-4
                t_clip = 9.2 / torch.clamp_min(sigma_bar, 1e-12)
                t1 = torch.minimum(t_surf, t_clip)
                w_seg, dt_seg, tot_seg = guided_distance_weights(
                    guide_state, dist_flux, o, d, t1, torch.broadcast_to(sigma_bar, (n,)))
                beta = torch.where(medium_on & (tot_seg > 1e-12) & (dt_seg > 1e-9), 0.5, 0.0)
                use_g = u[..., 11] < beta
                t_g = piecewise_sample(w_seg, dt_seg, tot_seg, u[..., 10])
                t_med = torch.where(use_g, t_g, t_med)
                is_medium = alive & (use_g | (t_med < t_surf))
            else:
                is_medium = alive & (t_med < t_surf)
            is_surface = alive & hit.valid & ~is_medium
            escaped = alive & ~hit.valid & ~is_medium

            # balance heuristic over the three channel samplers: a medium
            # event weighs by pdf(t_med), a surface event by the
            # probability that the sampled distance passed t_surf
            pdf_t, _ = _distance_pdfs(st_eff, t_med)
            tr_surf = transmittance(st_eff, t_surf)
            _, p_pass = _distance_pdfs(st_eff, t_surf)
            if use_guided_dist:
                # only the analytic branch can pass the surface
                pdf_g_t = piecewise_pdf(w_seg, dt_seg, tot_seg, t_med)
                pdf_t = beta * pdf_g_t + (1.0 - beta) * pdf_t
                p_pass = (1.0 - beta) * p_pass
            tr_med = transmittance(st_eff, t_med)
            w_medium = ss_eff * tr_med / torch.clamp_min(pdf_t, 1e-30)[..., None]
            w_surface = tr_surf / torch.clamp_min(p_pass, 1e-30)[..., None]
            # an escaped lane takes w_surface at t = INF: 0 unless sigma_t == 0
            T = torch.where(is_medium[..., None], T * w_medium,
                            torch.where((is_surface | escaped)[..., None], T * w_surface, T))

        # the environment on escape
        env_L = em_mod.eval_env(em, d, kinds=em_kinds)
        if use_nee:
            w_env = torch.where(prev_delta, 1.0, power_heuristic(
                prev_pdf, torch.broadcast_to(em_mod.pdf_env(em, d, kinds=em_kinds),
                                             prev_pdf.shape)))
        else:
            w_env = torch.ones_like(prev_pdf)
        L = torch.where(escaped[..., None], L + T * env_L * w_env[..., None], L)

        # the surface point, from one shading-row gather
        prim = torch.clamp_min(hit.prim, 0)
        t_hit = torch.where(hit.valid, hit.t, 1.0)
        p_surf = o + t_hit[..., None] * d
        row = gather_rows_t(geo.shade_packed, prim)  # (32, N)
        ng = torch.stack([row[0], row[1], row[2]], dim=-1)
        b0 = 1.0 - hit.u - hit.v
        ns = normalize(torch.stack(
            [
                b0 * row[3] + hit.u * row[6] + hit.v * row[9],
                b0 * row[4] + hit.u * row[7] + hit.v * row[10],
                b0 * row[5] + hit.u * row[8] + hit.v * row[11],
            ],
            dim=-1,
        ))
        ns = torch.where(dot(ns, ng)[..., None] < 0.0, -ns, ns)
        mid = row[18].to(torch.int32)
        is_emitter = row[19] >= 0.0
        mp = bsdf_mod.gather_params(mats, mid, types=mat_types)

        # an emissive surface hit, MIS'd against NEE (both strategies
        # share the medium's transmittance)
        cos_l = dot(ng, -d)
        Le = torch.where((is_emitter & (cos_l > 0.0))[..., None],
                         torch.stack([row[20], row[21], row[22]], dim=-1), 0.0)
        if use_nee:
            d_mis = t_hit + t_acc  # the distance through straight pass-throughs
            d2h = d_mis * d_mis
            pdf_nee_hit = row[23] * d2h / torch.clamp_min(
                torch.abs(cos_l) * torch.clamp_min(row[25], 1e-12), 1e-12)
            pdf_nee_hit = torch.where(is_emitter, pdf_nee_hit, 0.0)
            w_hit = torch.where(prev_delta, 1.0, power_heuristic(prev_pdf, pdf_nee_hit))
        else:
            w_hit = torch.ones_like(prev_pdf)
        L = torch.where(is_surface[..., None], L + T * Le * w_hit[..., None], L)

        p_med = o + t_med[..., None] * d
        p_event = torch.where(is_medium[..., None], p_med, p_surf)

        frame = Frame.from_normal(ns)
        wi_local = frame.to_local(-d)
        event = is_surface | is_medium

        first = event & (aux.depth_t == 0.0)
        aux = PathAux(
            albedo=torch.where(first[..., None], torch.where(
                is_medium[..., None], sigma_s / torch.clamp_min(torch.amax(sigma_t), 1e-6),
                bsdf_mod.albedo_p(mp)), aux.albedo),
            normal=torch.where(first[..., None], torch.where(is_medium[..., None], -d, ns),
                               aux.normal),
            depth_t=torch.where(first, torch.where(is_medium, t_med, hit.t), aux.depth_t),
            n_bounces=aux.n_bounces + event.to(torch.int32),
            first_le=torch.where((first & is_surface)[..., None], Le, aux.first_le),
        )

        # NEE from the event point, attenuated by the medium
        if use_nee:
            ds = em_mod.sample_direct(em, geo, p_event, u[..., 0:3], kinds=em_kinds)
            ph = phase_eval_kind(-d, ds.direction, g_hg, phase_kind, med)
            wo_local_nee = frame.to_local(ds.direction)
            f_surf, pdf_b_surf = bsdf_mod.eval_pdf_p(mp, wi_local, wo_local_nee,
                                                     types=mat_types)
            f_nee = torch.where(is_medium[..., None], ph[..., None] * torch.ones((1, 3), **f32),
                                f_surf)
            pdf_fwd = torch.where(is_medium, ph, pdf_b_surf)  # a phase's pdf is its value
            if guide is not None:
                # MIS against the guided strategies' densities, on the
                # surface and in the medium
                pdf_surf_c = guide.pdf_at(guide_state, mats, mid, p_surf, frame, ds.direction,
                                          pdf_b_surf, params=mp)
                alpha_g = getattr(guide, "alpha", 0.5)
                params_n = _gather_cells(guide_state, cell_index(guide_state, p_med))
                a_n = torch.where(params_n[-1], alpha_g, 0.0)
                pdf_med_c = a_n * _mixture_pdf(params_n, ds.direction) + (1.0 - a_n) * ph
                pdf_fwd = torch.where(is_medium, pdf_med_c, pdf_surf_c)
            o_sh = torch.where(is_medium[..., None], p_event,
                               _offset_ray(p_surf, ng, ds.direction))
            t_sh = torch.where(ds.distance >= INFD, INFD, ds.distance * (1.0 - 1e-3))
            tr_vis = vis_transmittance(o_sh, ds.direction, torch.where(event, t_sh, -1.0), depth)
            w_mis = torch.where(ds.is_delta, 1.0, power_heuristic(ds.pdf, pdf_fwd))
            contrib = (T * f_nee * tr_vis * ds.radiance
                       * (w_mis / torch.clamp_min(ds.pdf, 1e-12))[..., None])
            good = event & (ds.pdf > 0.0)
            L = torch.where(good[..., None], L + contrib, L)

        # continuation: the phase function (medium) or the BSDF (surface),
        # each optionally mixed with the guiding cache
        wo_phase, pdf_phase, w_phase = phase_sample_kind_w(-d, g_hg, u[..., 3:5], phase_kind, med)
        if guide is None:
            bs = bsdf_mod.sample_p(mp, wi_local, u[..., 3:6], types=mat_types)
            wo_surf_world = frame.to_world(bs.wo)
            surf_pdf, surf_w, surf_delta = bs.pdf, bs.weight, bs.is_delta
            wo_med, pdf_med = wo_phase, pdf_phase
            w_med = w_phase[..., None] * torch.ones((1, 3), **f32)
        else:
            wo_surf_world, surf_pdf, surf_w, surf_delta = guide(
                guide_state, mats, mid, p_surf, frame, wi_local, u[..., 3:6], u[..., 6],
                u[..., 7], params=mp)
            # in the medium: one-sample MIS of the phase and the vMF mixture
            alpha_g = getattr(guide, "alpha", 0.5)
            params_m = _gather_cells(guide_state, cell_index(guide_state, p_med))
            a_m = torch.where(params_m[-1], alpha_g, 0.0)
            d_gm = _mixture_sample(params_m, u[..., 7], u[..., 3:5])
            take_gm = u[..., 6] < a_m
            wo_med = torch.where(take_gm[..., None], d_gm, wo_phase)
            ph_val = phase_eval_kind(-d, wo_med, g_hg, phase_kind, med)
            pdf_med = a_m * _mixture_pdf(params_m, wo_med) + (1.0 - a_m) * ph_val
            w_med = (ph_val / torch.clamp_min(pdf_med, 1e-8))[..., None] * torch.ones((1, 3), **f32)

        d_next = torch.where(is_medium[..., None], wo_med, wo_surf_world)
        next_pdf = torch.where(is_medium, pdf_med, surf_pdf)
        next_delta = torch.where(is_medium, False, surf_delta)
        T_new = torch.where(is_medium[..., None], T * w_med, T * surf_w)

        cont = event & (torch.amax(torch.abs(T_new), dim=-1) > 0.0) & (next_pdf > 0.0)

        # russian roulette
        if depth >= rr_depth:
            q = torch.clamp(torch.amax(T_new, dim=-1), 0.05, 0.95)
            T_new = torch.where(cont[..., None], T_new / torch.clamp_min(q, 1e-6)[..., None],
                                T_new)
            cont = cont & (u[..., 8] < q)

        # a straight pass-through keeps the last real vertex's MIS state
        if transparent:
            straight = next_delta & (dot(d_next, d) > 1.0 - 1e-6)
            next_pdf_c = torch.where(straight, prev_pdf, next_pdf)
            next_delta_c = torch.where(straight, prev_delta, next_delta)
            t_acc_new = torch.where(straight, t_acc + t_hit, 0.0)
        else:
            next_pdf_c, next_delta_c, t_acc_new = next_pdf, next_delta, torch.zeros_like(t_acc)

        o_next = torch.where(is_medium[..., None], p_event,
                             _offset_ray(p_surf, ng, wo_surf_world))
        if record_paths:
            recs.append((p_event.T, d_next.T, luminance(L),
                         luminance(torch.where(cont[..., None], T_new, T)),
                         next_pdf, event & ~next_delta))
        o = torch.where(cont[..., None], o_next, o)
        d = torch.where(cont[..., None], d_next, d)
        T = torch.where(cont[..., None], T_new, T)
        prev_pdf = torch.where(cont, next_pdf_c, prev_pdf)
        prev_delta = torch.where(cont, next_delta_c, prev_delta)
        t_acc = torch.where(cont, t_acc_new, t_acc)
        alive = cont

    record = None
    if record_paths:
        rec_pos, rec_dir, rec_lumL, rec_lumT, rec_pdf, rec_valid = (
            torch.stack(x, dim=0) for x in zip(*recs))
        lum_final = luminance(L)[None, :]
        li = torch.clamp_min(lum_final - rec_lumL, 0.0) / torch.clamp_min(rec_lumT, 1e-6)
        record = PathRecord(pos=rec_pos, dir=rec_dir, li=li, pdf=rec_pdf, valid=rec_valid)
    return L, aux, record
