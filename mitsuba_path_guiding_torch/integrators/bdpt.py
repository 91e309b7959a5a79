"""Bidirectional path tracer with recursive VCM-style MIS (port of the
reference's integrators/bdpt.py ``trace_bdpt`` and ``render_bdpt``).

Each lane pairs one camera subpath, through its pixel, with one light
subpath.  Both walk max_depth bounces without roulette and keep their
vertices; the MIS weights are the balance heuristic through the
recursive quantities dVCM and dVC carried per vertex (Georgiev 2012,
"Implementing Vertex Connection and Merging").  Strategies of a path:

  s=0          the camera subpath hits an emitter (or escapes to the
               environment)
  s=1          next-event estimation from a camera vertex
  t=1          every light vertex, the emission vertex included, connects
               to the camera: the light-image splats
  s>=2, t>=1   interior connections between stored vertices, of at most
               max_depth + 1 edges

Every emitter family traces: finite (area, point, spot), infinite
(constant, envmap) and delta-infinite (directional; collimated, light
strategies only), with ``sample_ray``'s VCM pdfs and the bounding disk of
``models.emitter.scene_radius``.  Surfaces only.  The order of arithmetic
and the 1e-12 clamps are the reference's.  Queries route as
``integrators.path.route_dense_or_bvh``.
"""
from __future__ import annotations

import math

import torch

from mitsuba_path_guiding_torch.core.math import Frame, dot
from mitsuba_path_guiding_torch.core.rng import TAG_CAMERA, bounce_uniform, event_uniform, fold_in
from mitsuba_path_guiding_torch.integrators.path import INFD, _offset_ray, route_dense_or_bvh
from mitsuba_path_guiding_torch.integrators.ptracer import (
    TAG_EMITTER_RAY,
    _decode_hit,
    live_tmax,
    splat_light,
)
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.sensor import connect_to_sensor, generate_rays
from mitsuba_path_guiding_torch.scene.types import EmitterKind, SceneData

TAG_LIGHT_STREAM = 7 << 20

FINITE_KINDS = (EmitterKind.AREA, EmitterKind.POINT, EmitterKind.SPOT)


def _camera_pdf_w(sensor, width: int, height: int, d_world):
    """Solid-angle pdf, per sample of the pixel the direction hits, of a
    perspective camera ray: 1 / (A_pix * cos^3 theta)."""
    fwd = sensor.to_world[:3, 2]
    cos_t = torch.clamp_min(dot(d_world, fwd.expand_as(d_world)), 1e-6)
    aspect = height / width
    tanx = sensor.tan_half_fov_x
    a_pix = (2.0 * tanx / width) * (2.0 * tanx * aspect / height)
    return 1.0 / (a_pix * cos_t ** 3)


def _rev_pdf(mp, wi_local, wo_local, types):
    """Adjoint pdf: the density of sampling wi given wo."""
    return bsdf_mod.eval_pdf_p(mp, wo_local, wi_local, types=types)[1]


def _continue(mp, frame, wi_local, u, dVCM_v, dVC_v, T, types):
    """A subpath's BSDF-sampled continuation: (wo_world, T_new, the next
    vertex's dVCM and dVC, the lanes that go on)."""
    bs = bsdf_mod.sample_p(mp, wi_local, u[..., 3:6], types=types)
    wo_world = frame.to_world(bs.wo)
    p_rev = _rev_pdf(mp, bs.wo, wi_local, types)
    cos_out = torch.clamp_min(torch.abs(bs.wo[..., 2]), 1e-6)
    pf = torch.clamp_min(bs.pdf, 1e-12)
    dVC_n = torch.where(bs.is_delta, dVC_v * cos_out,
                        (cos_out / pf) * (dVCM_v + p_rev * dVC_v))
    dVCM_n = torch.where(bs.is_delta, 0.0, 1.0 / pf)
    T_new = T * bs.weight
    cont = (bs.pdf > 0.0) & (torch.amax(torch.abs(T_new), dim=-1) > 0.0)
    return wo_world, T_new, dVCM_n, dVC_n, cont


def trace_bdpt(
    scene: SceneData,
    rkeys: torch.Tensor,
    pix: torch.Tensor,
    width: int,
    height: int,
    max_depth: int = 5,
    use_bvh: bool = False,
    accel: str = "auto",
    em_kinds=FINITE_KINDS,
    mat_types=bsdf_mod.PORTED_TYPES,
):
    """One BDPT wave.  Returns (L (N, 3), the lane's pixel estimate; the
    light splats (film_xy (A, N, 2), rgb (A, 3, N), ok (A, N)), to be added
    to the light image divided by the total light-path count; the number
    of camera segments, a 0-d tensor)."""
    bsdf_mod.check_types(mat_types)
    geo, mats, em = scene.geo, scene.mats, scene.emitters
    intersect, occluded = route_dense_or_bvh(scene, accel, use_bvh)
    has_env = EmitterKind.CONSTANT in em_kinds or EmitterKind.ENVMAP in em_kinds
    # the infinite emitters' disk, as sample_ray draws it
    radius = em_mod.scene_radius(scene.aabb_min, scene.aabb_max)
    disk_area = math.pi * radius * radius
    n = pix.shape[0]
    n_pix = width * height  # light-subpath count of the t=1 MIS
    dev = pix.device
    f32 = dict(dtype=torch.float32, device=dev)

    lkeys = fold_in(rkeys, TAG_LIGHT_STREAM)

    # ---- light subpath: emit, walk, keep the vertices, t=1 splats
    u0 = event_uniform(lkeys, TAG_EMITTER_RAY, 5)
    rs = em_mod.sample_ray(em, scene.aabb_min, scene.aabb_max, u0, kinds=em_kinds)

    # the emission vertex to the camera (a=1, t=1), weighted against s=0;
    # point and spot lights have no area on the sensor side and the
    # infinite emitters' disk origin is virtual: s=1 draws their image
    film0, to_cam0, dist0, imp0, okc0 = connect_to_sensor(scene.sensor, width, height, rs.o)
    cos_q = dot(rs.normal, to_cam0)
    point_like = dot(rs.normal, rs.normal) < 0.5
    cos_conn = torch.where(point_like, 1.0, torch.clamp_min(cos_q, 0.0))
    live0 = rs.valid & okc0 & ~point_like & ~rs.infinite
    occ0 = occluded(rs.o, to_cam0, live_tmax(dist0 * (1.0 - 1e-3), live0))
    splat0 = rs.emit_weight * (cos_conn * imp0)[..., None]
    cam_pdf_a0 = imp0 * cos_conn  # area pdf of the camera sampling the emitter point
    w_light0 = cam_pdf_a0 / (n_pix * torch.clamp_min(rs.direct_pdf_a, 1e-12))
    mis0 = 1.0 / (1.0 + w_light0)
    splat0 = splat0 * mis0[..., None]
    ok0 = live0 & ~occ0 & (torch.amax(splat0, dim=-1) > 0.0)
    xys, rgbs, oks = [film0], [splat0.T], [ok0]

    # VCM state at the emission vertex; a delta-position emitter cannot be
    # hit by a camera ray, so dVC's strategy does not exist for it
    e_pdf = torch.clamp_min(rs.emission_pdf_w, 1e-12)
    dVCM = rs.direct_pdf_a / e_pdf
    dVC = torch.where(point_like, 0.0, rs.cos_light / e_pdf)

    o, d = rs.o, rs.d
    T = torch.where(rs.valid[..., None], rs.weight, 0.0)
    alive = rs.valid
    lverts = []
    for depth in range(max_depth):
        u = bounce_uniform(lkeys, depth, 9)
        hit = intersect(o, d, torch.where(alive, INFD, -1.0))
        act = alive & hit.valid
        p, ng, ns, row, t_hit = _decode_hit(geo, hit, o, d)
        mid = row[18].to(torch.int32)
        mp = bsdf_mod.gather_params(mats, mid, types=mat_types)
        frame = Frame.from_normal(ns)
        wi_local = frame.to_local(-d)
        cos_in = torch.clamp_min(torch.abs(wi_local[..., 2]), 1e-6)

        # to the area measure at this vertex; an infinite emitter's
        # emission pdf is already per disk area, so its first segment
        # takes no distance factor
        d2 = torch.clamp_min(t_hit * t_hit, 1e-12)
        if depth == 0:
            d2 = torch.where(rs.infinite, 1.0, d2)
        dVCM_v = dVCM * d2 / cos_in
        dVC_v = dVC / cos_in

        # t=1: this vertex to the camera
        film_xy, to_cam, dist_cam, imp, okc = connect_to_sensor(scene.sensor, width, height, p)
        wo_cam = frame.to_local(to_cam)
        f_cam, _ = bsdf_mod.eval_pdf_p(mp, wi_local, wo_cam, types=mat_types)
        p_rev_cam = _rev_pdf(mp, wi_local, wo_cam, mat_types)
        occ = occluded(_offset_ray(p, ng, to_cam), to_cam,
                       live_tmax(dist_cam * (1.0 - 1e-3), act & okc))
        cam_pdf_a = imp * torch.clamp_min(torch.abs(dot(ns, to_cam)), 1e-6)
        w_light = (cam_pdf_a / n_pix) * (dVCM_v + p_rev_cam * dVC_v)
        mis = 1.0 / (1.0 + w_light)
        splat = T * f_cam * (imp * mis)[..., None]
        xys.append(film_xy)
        rgbs.append(splat.T)
        oks.append(act & okc & ~occ & (torch.amax(splat, dim=-1) > 0.0))

        lverts.append((p, ns, ng, -d, mp, T, dVCM_v, dVC_v, act))
        wo_world, T_new, dVCM_n, dVC_n, cont = _continue(mp, frame, wi_local, u, dVCM_v, dVC_v,
                                                         T, mat_types)
        cont = act & cont
        o = torch.where(cont[..., None], _offset_ray(p, ng, wo_world), o)
        d = torch.where(cont[..., None], wo_world, d)
        T = torch.where(cont[..., None], T_new, T)
        dVCM = torch.where(cont, dVCM_n, dVCM)
        dVC = torch.where(cont, dVC_n, dVC)
        alive = cont
    light_splats = (torch.stack(xys), torch.stack(rgbs), torch.stack(oks))

    # ---- camera subpath: s=0 and s=1 as it walks, keep the vertices
    u_cam = event_uniform(rkeys, TAG_CAMERA, 2)
    o, d, _ = generate_rays(scene.sensor, width, height, pix, u_cam)
    dVCM = float(n_pix) / _camera_pdf_w(scene.sensor, width, height, d)
    dVC = torch.zeros((n,), **f32)
    L = torch.zeros((n, 3), **f32)
    T = torch.ones((n, 3), **f32)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    n_seg = torch.zeros((), dtype=torch.int64, device=dev)
    cverts = []
    for depth in range(max_depth):
        u = bounce_uniform(rkeys, depth, 9)
        hit = intersect(o, d, torch.where(alive, INFD, -1.0))
        act = alive & hit.valid
        n_seg = n_seg + act.sum()
        p, ng, ns, row, t_hit = _decode_hit(geo, hit, o, d)
        mid = row[18].to(torch.int32)
        mp = bsdf_mod.gather_params(mats, mid, types=mat_types)
        frame = Frame.from_normal(ns)
        wi_local = frame.to_local(-d)
        cos_in = torch.clamp_min(torch.abs(wi_local[..., 2]), 1e-6)
        d2 = torch.clamp_min(t_hit * t_hit, 1e-12)
        dVCM_v = dVCM * d2 / cos_in
        dVC_v = dVC / cos_in

        # s=0: an emissive hit (area lights carry their row in the
        # shading table)
        is_emitter = row[19] >= 0.0
        cos_l = dot(ng, -d)
        Le = torch.where((is_emitter & (cos_l > 0.0))[..., None],
                         torch.stack([row[20], row[21], row[22]], dim=-1), 0.0)
        direct_pdf_a = row[23] / torch.clamp_min(row[25], 1e-12)  # pmf / area
        emission_pdf_w = direct_pdf_a * torch.clamp_min(cos_l, 0.0) / math.pi
        w_cam_hit = direct_pdf_a * dVCM_v + emission_pdf_w * dVC_v
        mis_hit = 1.0 / (1.0 + w_cam_hit)
        L = torch.where(act[..., None], L + T * Le * mis_hit[..., None], L)

        # s=0 on escape: the environment, with dVCM and dVC unconverted
        # and the pdfs per solid angle and disk area
        if has_env:
            esc = alive & ~hit.valid
            env_L = em_mod.eval_env(em, d, kinds=em_kinds)
            pd_env = torch.broadcast_to(em_mod.pdf_env(em, d, kinds=em_kinds), esc.shape)
            em_pdf_env = pd_env / disk_area
            w_cam_esc = pd_env * dVCM + em_pdf_env * dVC
            mis_esc = 1.0 / (1.0 + w_cam_esc)
            L = torch.where(esc[..., None], L + T * env_L * mis_esc[..., None], L)

        # s=1: a fresh next-event sample with its VCM weight
        ds = em_mod.sample_direct(em, geo, p, u[..., 0:3], kinds=em_kinds, vcm=True)
        wo_nee = frame.to_local(ds.direction)
        f_nee, pdf_bsdf_nee = bsdf_mod.eval_pdf_p(mp, wi_local, wo_nee, types=mat_types)
        p_rev_nee = _rev_pdf(mp, wi_local, wo_nee, mat_types)
        t_sh = torch.where(ds.distance >= INFD, INFD, ds.distance * (1.0 - 1e-3))
        occ = occluded(_offset_ray(p, ng, ds.direction), ds.direction,
                       live_tmax(t_sh, act & (ds.pdf > 0.0)))
        pdf_dir_w = torch.clamp_min(ds.pdf, 1e-12)
        cos_to_l = torch.abs(wo_nee[..., 2])
        # a delta finite emitter's pdf is a pick probability (its 1 / d^2
        # is in the radiance): the ratio needs it per solid angle; a delta
        # infinite one keeps the pick probability, emission / direct being
        # 1 / disk area
        inf_delta = ds.is_delta & (ds.distance >= INFD)
        d_l = torch.clamp_max(ds.distance, 1e9)
        pdf_dir_mis = torch.where(ds.is_delta & ~inf_delta, pdf_dir_w * d_l * d_l, pdf_dir_w)
        w_light_nee = torch.where(ds.is_delta, 0.0, pdf_bsdf_nee / pdf_dir_w)
        # environment NEE: sample_direct leaves the extras zero; the
        # emission pdf is the direction pdf over the disk area, cos 1
        is_env_nee = ((ds.distance >= INFD) & ~ds.is_delta) | inf_delta
        nee_em_pdf = torch.where(is_env_nee, pdf_dir_w / disk_area, ds.emission_pdf_w)
        nee_cos_l = torch.where(is_env_nee, 1.0, ds.cos_light)
        w_cam_nee = (nee_em_pdf * cos_to_l
                     / (pdf_dir_mis * torch.clamp_min(nee_cos_l, 1e-6))) * (dVCM_v
                                                                             + p_rev_nee * dVC_v)
        mis_nee = 1.0 / (w_light_nee + 1.0 + w_cam_nee)
        contrib = T * f_nee * ds.radiance * (mis_nee / pdf_dir_w)[..., None]
        good = act & ~occ & (ds.pdf > 0.0)
        L = torch.where(good[..., None], L + contrib, L)

        cverts.append((p, ns, ng, -d, mp, T, dVCM_v, dVC_v, act))
        wo_world, T_new, dVCM_n, dVC_n, cont = _continue(mp, frame, wi_local, u, dVCM_v, dVC_v,
                                                         T, mat_types)
        cont = act & cont
        o = torch.where(cont[..., None], _offset_ray(p, ng, wo_world), o)
        d = torch.where(cont[..., None], wo_world, d)
        T = torch.where(cont[..., None], T_new, T)
        dVCM = torch.where(cont, dVCM_n, dVCM)
        dVC = torch.where(cont, dVC_n, dVC)
        alive = cont

    # ---- interior connections: light vertex a = i + 2 (the first stored
    # hit is l_2) with camera vertex b = j + 1, of a + b <= max_depth + 1
    for i, (lp, lns, lng, lwi, lmp, lT, ldVCM, ldVC, lact) in enumerate(lverts):
        for j, (cp, cns, cng, cwi, cmp, cT, cdVCM, cdVC, cact) in enumerate(cverts):
            if (i + 2) + (j + 1) > max_depth + 1:
                continue
            seg = lp - cp
            d2 = torch.clamp_min(dot(seg, seg), 1e-12)
            dist = torch.sqrt(d2)
            dir_cl = seg / dist[..., None]  # camera vertex -> light vertex
            cframe = Frame.from_normal(cns)
            lframe = Frame.from_normal(lns)
            c_wi_l = cframe.to_local(cwi)
            c_wo_l = cframe.to_local(dir_cl)
            l_wi_l = lframe.to_local(lwi)
            l_wo_l = lframe.to_local(-dir_cl)
            f_c, pdf_c_dir = bsdf_mod.eval_pdf_p(cmp, c_wi_l, c_wo_l, types=mat_types)
            pdf_c_rev = _rev_pdf(cmp, c_wi_l, c_wo_l, mat_types)
            f_l, pdf_l_dir = bsdf_mod.eval_pdf_p(lmp, l_wi_l, l_wo_l, types=mat_types)
            pdf_l_rev = _rev_pdf(lmp, l_wi_l, l_wo_l, mat_types)
            cos_c = torch.abs(c_wo_l[..., 2])
            cos_l = torch.abs(l_wo_l[..., 2])
            # f carries |cos| at its own vertex: the geometry term is 1 / d^2
            geom = 1.0 / d2
            occ = occluded(_offset_ray(cp, cng, dir_cl), dir_cl,
                           live_tmax(dist * (1.0 - 2e-3), lact & cact))
            pdf_c_dir_a = pdf_c_dir * cos_l / d2
            pdf_l_dir_a = pdf_l_dir * cos_c / d2
            w_light = pdf_c_dir_a * (ldVCM + pdf_l_rev * ldVC)
            w_cam = pdf_l_dir_a * (cdVCM + pdf_c_rev * cdVC)
            mis = 1.0 / (w_light + 1.0 + w_cam)
            contrib = cT * f_c * lT * f_l * (geom * mis)[..., None]
            ok = lact & cact & ~occ & (torch.amax(contrib, dim=-1) > 0.0)
            L = torch.where(ok[..., None], L + contrib, L)

    return L, light_splats, n_seg


def render_bdpt(scene: SceneData, cfg, light_image: bool = True):
    """BDPT render: spp camera samples a pixel, one light subpath each; a
    wave is the whole image.  ``light_image`` adds the t=1 splats, divided
    by the light-path count.  Returns (H, W, 3) on the scene's device."""
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    w, h = cfg.width, cfg.height
    n_pix = w * h
    dev = scene.geo.p0.device
    em_kinds = kinds_present(scene.emitters)
    mat_types = types_present(scene.mats)
    key = rng.base_key(cfg.seed, device=dev)
    pix = torch.arange(n_pix, dtype=torch.int64, device=dev)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    light_acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        rkeys = rng.ray_keys(key, pix, torch.full_like(pix, s))
        L, lsplats, _ = trace_bdpt(scene, rkeys, pix, w, h, max_depth=cfg.max_depth,
                                   accel=cfg.accel, em_kinds=em_kinds, mat_types=mat_types)
        acc = acc + L
        if light_image:
            light_acc = splat_light(light_acc, lsplats, w, h)
    img = acc / float(cfg.spp)
    if light_image:
        img = img + light_acc / float(cfg.spp * n_pix)
    return img.reshape(h, w, 3)
