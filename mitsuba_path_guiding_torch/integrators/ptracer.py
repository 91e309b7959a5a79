"""Adjoint particle (light) tracer: emitter rays splatting onto the sensor
(port of the reference's integrators/ptracer.py ``trace_light`` and
``render_ptracer``).

Particles start on the emitters (``models.emitter.sample_ray``), walk the
scene by BSDF sampling with Russian roulette, and connect the emission
vertex and every surface vertex to the camera: a shadow ray and a film
coordinate.  A wave returns its splat data, depth + 1 rows; the render
splats them with ``film.splat_raw`` (an order fixed by the data, so a
render repeats bit for bit) and divides by the total particle count, since
a particle can splat anywhere on the film.

Queries route as ``integrators.path.route_dense_or_bvh``: "auto" takes the
tiled kernel at 16384 triangles or fewer and the BVH above, where the
reference takes its dense oracle (the same winner).
"""
from __future__ import annotations

import torch

from mitsuba_path_guiding_torch.core.math import Frame, dot, normalize
from mitsuba_path_guiding_torch.core.rng import bounce_uniform, event_uniform
from mitsuba_path_guiding_torch.integrators.path import INFD, _offset_ray, route_dense_or_bvh
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.sensor import connect_to_sensor
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import SceneData

TAG_EMITTER_RAY = 4 << 20


def _decode_hit(geo, hit, o, d):
    """Hit decode shared by the light-path integrators: (position,
    geometric normal, shading normal flipped to its side, the (32, N)
    shading rows, t with 1 on a miss)."""
    prim = torch.clamp_min(hit.prim, 0)
    t_hit = torch.where(hit.valid, hit.t, 1.0)
    p = o + t_hit[..., None] * d
    row = gather_rows_t(geo.shade_packed, prim)
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
    return p, ng, ns, row, t_hit


def live_tmax(tmax, live):
    """Shadow-ray lengths with -1 on lanes whose result is masked off (the
    query does no work for them)."""
    return torch.where(live, tmax, -1.0)


def trace_light(
    scene: SceneData,
    rkeys: torch.Tensor,
    width: int,
    height: int,
    max_depth: int = 5,
    rr_depth: int = 5,
    accel: str = "auto",
    em_kinds=em_mod.PORTED_KINDS,
    mat_types=bsdf_mod.PORTED_TYPES,
):
    """One wave of light particles, one a key.  Returns the splat data of
    the emission vertex and of each bounce: (film_xy (D + 1, N, 2), rgb
    (D + 1, 3, N), ok (D + 1, N))."""
    bsdf_mod.check_types(mat_types)
    geo, mats, em = scene.geo, scene.mats, scene.emitters
    intersect, occluded = route_dense_or_bvh(scene, accel)

    u0 = event_uniform(rkeys, TAG_EMITTER_RAY, 5)
    rs = em_mod.sample_ray(em, scene.aabb_min, scene.aabb_max, u0, kinds=em_kinds)

    # the emission vertex itself seen by the sensor: radiance on the
    # normal side of area lights only
    film_xy0, to_cam0, dist0, imp0, ok0 = connect_to_sensor(scene.sensor, width, height, rs.o)
    cos_q = dot(rs.normal, to_cam0)
    occ0 = occluded(rs.o, to_cam0, live_tmax(dist0 * (1.0 - 1e-3), rs.valid & ok0))
    splat0_rgb = rs.emit_weight * (torch.clamp_min(cos_q, 0.0) * imp0)[..., None]
    splat0_ok = rs.valid & ok0 & ~occ0 & (torch.amax(splat0_rgb, dim=-1) > 0.0)
    xys, rgbs, oks = [film_xy0], [splat0_rgb.T], [splat0_ok]

    o, d = rs.o, rs.d
    T = torch.where(rs.valid[..., None], rs.weight, 0.0)
    alive = rs.valid
    for depth in range(max_depth):
        u = bounce_uniform(rkeys, depth, 9)
        hit = intersect(o, d, torch.where(alive, INFD, -1.0))
        act = alive & hit.valid
        p, ng, ns, row, _ = _decode_hit(geo, hit, o, d)
        mid = row[18].to(torch.int32)
        mp = bsdf_mod.gather_params(mats, mid, types=mat_types)
        frame = Frame.from_normal(ns)
        wi_local = frame.to_local(-d)

        # connect to the sensor; the BSDF is reciprocal where eval sees it
        # (delta refraction, the non-reciprocal case, is not in eval)
        film_xy, to_cam, dist_cam, imp, valid_cam = connect_to_sensor(
            scene.sensor, width, height, p)
        f_cam, _ = bsdf_mod.eval_pdf_p(mp, wi_local, frame.to_local(to_cam), types=mat_types)
        occ = occluded(_offset_ray(p, ng, to_cam), to_cam,
                       live_tmax(dist_cam * (1.0 - 1e-3), act & valid_cam))
        splat_rgb = T * f_cam * imp[..., None]
        xys.append(film_xy)
        rgbs.append(splat_rgb.T)
        oks.append(act & valid_cam & ~occ & (torch.amax(splat_rgb, dim=-1) > 0.0))

        # continue the walk by BSDF sampling
        bs = bsdf_mod.sample_p(mp, wi_local, u[..., 3:6], types=mat_types)
        wo_world = frame.to_world(bs.wo)
        T_new = T * bs.weight
        cont = act & (bs.pdf > 0.0) & (torch.amax(torch.abs(T_new), dim=-1) > 0.0)
        if depth >= rr_depth:
            q = torch.clamp(torch.amax(T_new, dim=-1), 0.05, 0.95)
            T_new = torch.where(cont[..., None], T_new / torch.clamp_min(q, 1e-6)[..., None],
                                T_new)
            cont = cont & (u[..., 8] < q)
        o = torch.where(cont[..., None], _offset_ray(p, ng, wo_world), o)
        d = torch.where(cont[..., None], wo_world, d)
        T = torch.where(cont[..., None], T_new, T)
        alive = cont
    return torch.stack(xys), torch.stack(rgbs), torch.stack(oks)


def splat_light(acc, splats, width: int, height: int):
    """Add a wave's light splats ((A, N, 2), (A, 3, N), (A, N)) to the raw
    (H * W, 3) accumulator, rows in order."""
    from mitsuba_path_guiding_torch.film.film import splat_raw

    film_xy, rgb, ok = splats
    a, m = ok.shape
    val = torch.movedim(rgb, 1, 2).reshape(a * m, 3)
    return splat_raw(acc, film_xy.reshape(a * m, 2),
                     torch.where(ok.reshape(a * m)[..., None], val, 0.0), width, height)


def render_ptracer(scene: SceneData, cfg, n_particles: int | None = None):
    """Light-traced render; ``cfg`` is a RenderConfig whose spp counts
    particles a pixel (or ``n_particles`` in all), traced in waves of at
    most ``cfg.pixel_batch``.  Returns (H, W, 3) on the scene's device."""
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    w, h = cfg.width, cfg.height
    dev = scene.geo.p0.device
    n_total = n_particles or (w * h * cfg.spp)
    em_kinds = kinds_present(scene.emitters)
    mat_types = types_present(scene.mats)
    key = rng.base_key(cfg.seed, device=dev)
    batch = min(n_total, cfg.pixel_batch)
    acc = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    done = wave = 0
    while done < n_total:
        m = min(batch, n_total - done)
        pid = torch.arange(m, dtype=torch.int64, device=dev)
        rkeys = rng.ray_keys(key, pid, torch.full_like(pid, wave))
        splats = trace_light(scene, rkeys, w, h, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                             accel=cfg.accel, em_kinds=em_kinds, mat_types=mat_types)
        acc = splat_light(acc, splats, w, h)
        done += m
        wave += 1
    return acc.reshape(h, w, 3) / float(n_total)
