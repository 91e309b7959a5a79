"""Motion vectors and motion blur over animated scenes (port of the
reference's integrators/motion.py).

Geometry is interpolated on the host (``scene/animation.py``): each scene
compiles at a concrete time and the kernels stay the same.
``render_motion`` intersects the first hit at t0, moves the hit point with
its triangle to t1 (the same primitive and barycentrics: both compiles
share their topology) and reprojects it through the t1 camera, giving
per-pixel film-space (dx, dy).  Its query routes as
``integrators.path.route_dense_or_bvh`` (the tiled kernel up to
BRUTE_FORCE_MAX_TRIS triangles, else the BVH), where the reference calls
its dense oracle.  ``render_motion_blur`` averages ``time_bins`` renders,
each of the scene baked at a jittered time of its slice of the shutter;
the slice times come from the reference's host generator, so they are its
times bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_path_guiding_torch.accel.traverse import INF
from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.integrators.path import route_dense_or_bvh
from mitsuba_path_guiding_torch.scene.animation import scene_at_time


def render_motion(desc: dict, cfg, t0: float = 0.0, t1: float = 1.0, device=None):
    """(H, W, 3) on ``device``: film-space motion (dx, dy, 0) of the first
    hit from shutter time t0 to t1."""
    from mitsuba_path_guiding_torch.models.sensor import connect_to_sensor, generate_rays
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    dev = resolve_device(device)
    scene0 = build_scene(scene_at_time(desc, t0), device=dev)
    scene1 = build_scene(scene_at_time(desc, t1), device=dev)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    pix = torch.arange(n_pix, dtype=torch.int64, device=dev)
    u_cam = torch.full((n_pix, 2), 0.5, device=dev)  # pixel centres
    o, d, film0 = generate_rays(scene0.sensor, w, h, pix, u_cam, kind=int(scene0.sensor.kind))
    intersect, _ = route_dense_or_bvh(scene0)
    hit = intersect(o, d, torch.full((n_pix,), INF, device=dev))
    # the hit point at t0 moved to t1 with its triangle
    prim = torch.clamp_min(hit.prim, 0).to(torch.int64)
    geo1 = scene1.geo
    p1 = geo1.p0[prim] + hit.u[..., None] * geo1.e1[prim] + hit.v[..., None] * geo1.e2[prim]
    film1, _, _, _, ok1 = connect_to_sensor(scene1.sensor, w, h, p1)
    dxy = torch.where((hit.valid & ok1)[..., None], film1 - film0, 0.0)
    out = torch.cat([dxy, torch.zeros_like(dxy[..., :1])], dim=-1)
    return out.reshape(h, w, 3)


def render_motion_blur(desc: dict, cfg, shutter=(0.0, 1.0), time_bins: int = 8, device=None):
    """Stratified-time motion blur: ``time_bins`` renders at jittered slice
    times, averaged; (H, W, 3) on ``device``.  (The reference's ``guide``
    argument, which it never reads, is left out.)"""
    from mitsuba_path_guiding_torch.integrators.render import render
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    dev = resolve_device(device)
    t0, t1 = shutter
    acc = None
    rs = np.random.default_rng(cfg.seed)
    for b in range(time_bins):
        tb = t0 + (b + rs.random()) / time_bins * (t1 - t0)
        scene_b = build_scene(scene_at_time(desc, tb), device=dev)
        img = render(scene_b, cfg._replace(seed=cfg.seed + 101 * b))
        acc = img if acc is None else acc + img
    return acc / time_bins
