"""Microbenchmark of the port's big-scene intersectors without pair tables,
on one card.

  python3 tools/profile_blocklist_torch.py [n_tris] [n_rays] [--old] [--device cpu]

Builds an interior scene (a 10^3 room of 12 triangles and a 4x4x4 grid of
tessellated spheres, about n_tris triangles, default 300000), then times
a primary wave (n_rays coherent camera rays from a room corner, default
524288) and a bounce wave (cosine-hemisphere rays from the primary hits)
through ``intersect_blocklist_sorted``, the blocklist kernel on
Morton-sorted rays.  With ``--old`` the same two waves also go through
``intersect_blocks_sorted``, the two-level superblock kernel.  Each wave
prints one JSON line: the median of 7 CUDA-event timings, Mrays/s, the
hit rate and the card's name and power limit (nvidia-smi).  Without a
card it raises unless ``--device cpu`` asks for a rehearsal, which
prints host times (``host_ms``) and no rate.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_sphere(center, radius, nu, nv):
    """Tessellated UV sphere -> (p0, e1, e2) triangle arrays."""
    u = np.linspace(0, 2 * np.pi, nu + 1)
    v = np.linspace(0, np.pi, nv + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = center[0] + radius * np.cos(uu) * np.sin(vv)
    y = center[1] + radius * np.sin(uu) * np.sin(vv)
    z = center[2] + radius * np.cos(vv)
    P = np.stack([x, y, z], axis=-1)  # (nu+1, nv+1, 3)
    a = P[:-1, :-1].reshape(-1, 3)
    b = P[1:, :-1].reshape(-1, 3)
    c = P[:-1, 1:].reshape(-1, 3)
    d = P[1:, 1:].reshape(-1, 3)
    p0 = np.concatenate([a, b])
    p1 = np.concatenate([b, d])
    p2 = np.concatenate([c, c])
    return p0, p1 - p0, p2 - p0


def make_quad(p, ea, eb):
    p = np.asarray(p, np.float32)
    ea = np.asarray(ea, np.float32)
    eb = np.asarray(eb, np.float32)
    return np.stack([p, p + ea + eb]), np.stack([ea, -ea]), np.stack([eb, -eb])


def make_interior(target_tris: int, seed=0):
    """Room (12 triangles) and a 4x4x4 grid of spheres sized to about
    target_tris triangles: float32 (p0, e1, e2)."""
    rs = np.random.default_rng(seed)
    parts = []
    for p, ea, eb in [
        ((-5, -5, -5), (10, 0, 0), (0, 10, 0)),
        ((-5, -5, 5), (10, 0, 0), (0, 10, 0)),
        ((-5, -5, -5), (10, 0, 0), (0, 0, 10)),
        ((-5, 5, -5), (10, 0, 0), (0, 0, 10)),
        ((-5, -5, -5), (0, 10, 0), (0, 0, 10)),
        ((5, -5, -5), (0, 10, 0), (0, 0, 10)),
    ]:
        parts.append(make_quad(p, ea, eb))
    n_spheres = 64
    per = max(target_tris // n_spheres, 32)
    nu = max(int(np.sqrt(per / 2)), 4)
    g = 4
    for i in range(n_spheres):
        cx = (i % g - (g - 1) / 2) * 2.2
        cy = ((i // g) % g - (g - 1) / 2) * 2.2
        cz = (i // (g * g) - (g - 1) / 2) * 2.2
        c = np.array([cx, cy, cz]) + rs.normal(0, 0.2, 3)
        parts.append(make_sphere(c, 0.8, nu, nu))
    p0 = np.concatenate([p[0] for p in parts]).astype(np.float32)
    e1 = np.concatenate([p[1] for p in parts]).astype(np.float32)
    e2 = np.concatenate([p[2] for p in parts]).astype(np.float32)
    return p0, e1, e2


def camera_rays(n, seed=0):
    """Perspective rays from a room corner: float32 (o, d)."""
    rs = np.random.default_rng(seed)
    side = int(np.sqrt(n))
    px = (np.arange(n) % side + rs.random(n)) / side - 0.5
    py = (np.arange(n) // side % side + rs.random(n)) / side - 0.5
    o = np.tile(np.array([-4.5, -4.5, 2.0], np.float32), (n, 1))
    fwd = np.array([1.0, 1.0, -0.4])
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    d = fwd[None] + 1.2 * (px[:, None] * right[None] + py[:, None] * up[None])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def bounce_rays(p0, e1, e2, o, d, hit_t, hit_prim, seed=1):
    """Cosine-hemisphere rays from the primary hit points: float32 (o, d)."""
    rs = np.random.default_rng(seed)
    n = o.shape[0]
    hp = o + hit_t[:, None] * d
    ng = np.cross(e1[hit_prim], e2[hit_prim])
    ng /= np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True), 1e-12)
    ng *= -np.sign(np.sum(ng * d, axis=-1, keepdims=True))
    u1, u2 = rs.random(n), rs.random(n)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    t = np.where(np.abs(ng[:, 0:1]) < 0.9, np.array([[1.0, 0, 0]]), np.array([[0, 1.0, 0]]))
    x = np.cross(ng, t)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    y = np.cross(ng, x)
    local = np.stack([r * np.cos(phi), r * np.sin(phi), np.sqrt(1 - u1)], -1)
    dd = local[:, 0:1] * x + local[:, 1:2] * y + local[:, 2:3] * ng
    return (hp + 1e-3 * ng).astype(np.float32), dd.astype(np.float32)


def interior_waves(p0, e1, e2, n_rays, first_hit, dev):
    """The camera wave and the bounce wave from its hits, as tensors on
    ``dev``: ((o, d), (o, d)); ``first_hit(o, d, tmax)`` gives the camera
    wave's (t, prim, u, v, valid)."""
    import torch

    o, d = camera_rays(n_rays, seed=0)
    tmax = torch.full((n_rays,), 3.0e38, device=dev)
    cam = (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev))
    t, prim, _, _, valid = first_hit(*cam, tmax)
    t_np = np.where(valid.cpu().numpy(), t.cpu().numpy(), 1.0)
    ob, db = bounce_rays(p0, e1, e2, o, d, t_np, np.maximum(prim.cpu().numpy(), 0), seed=1)
    return cam, (torch.from_numpy(ob).to(dev), torch.from_numpy(db).to(dev))


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _time(fn, dev, reps=7):
    """Median ms of ``reps`` runs after one warm-up: CUDA events on the
    card, the host clock on the CPU."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_tris", type=int, nargs="?", default=300_000)
    ap.add_argument("n_rays", type=int, nargs="?", default=524_288)
    ap.add_argument("--old", action="store_true", help="also time the two-level kernel")
    ap.add_argument("--device", default=None, help="cpu for a rehearsal without the card")
    args = ap.parse_args(argv)
    import torch

    from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
    from mitsuba_path_guiding_torch.accel.bvh import build_bvh, to_device
    from mitsuba_path_guiding_torch.core.device import resolve_device
    from mitsuba_path_guiding_torch.ops import build
    from mitsuba_path_guiding_torch.ops.intersect_blocklist import intersect_blocklist_sorted
    from mitsuba_path_guiding_torch.ops.intersect_twolevel import (
        build_blocks,
        intersect_blocks_sorted,
    )

    dev = resolve_device(args.device)
    card = _card() if dev.type == "cuda" else "cpu (host times, no device metric)"
    if dev.type == "cuda":
        build.build_all(("intersect_blocklist", "intersect_twolevel"))
    p0, e1, e2 = make_interior(args.n_tris)
    t0 = time.perf_counter()
    bl = to_device(build_blocklist(p0, e1, e2, build_bvh(p0, e1, e2)), dev)
    t1 = time.perf_counter()
    print(json.dumps({"scene_tris": int(p0.shape[0]), "rays_per_wave": args.n_rays,
                      "blocklist_superblocks": int(bl.sb_lo.shape[0]),
                      "build_s": round(t1 - t0, 3), "card": card}), flush=True)
    tmax = torch.full((args.n_rays,), 3.0e38, device=dev)
    routes = {"blocklist_sorted": lambda o, d, t: intersect_blocklist_sorted(bl, o, d, t)}
    if args.old:
        bt = build_blocks(p0, e1, e2, device=dev)
        routes["twolevel_sorted"] = lambda o, d, t: intersect_blocks_sorted(bt, o, d, t)
    cam, bounce = interior_waves(p0, e1, e2, args.n_rays, routes["blocklist_sorted"], dev)
    for route, fn in routes.items():
        for wave, (o, d) in (("primary", cam), ("bounce", bounce)):
            ms = _time(lambda: fn(o, d, tmax), dev)
            row = {"route": route, "wave": wave,
                   "hit_rate": float(fn(o, d, tmax)[4].float().mean()), "card": card}
            if dev.type == "cuda":
                row.update(ms=ms, mrays_per_s=args.n_rays / ms / 1e3)
            else:
                row.update(host_ms=ms)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
