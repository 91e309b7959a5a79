"""Where the time of the PyTorch port's main path goes, on one card.

  python3 tools/profile_torch_main_path.py [--res N] [--trace DIR] [--device cpu]

Builds the CUDA kernels, renders the built-in Cornell box with the guided
ProgressiveRenderer (depth 5, 4 spp per progression, 16^3 grid of 8
lobes), and traces two windows with torch.profiler after one untraced
warm-up of each:

  * ``progressive``: one progression (4 wavefront waves, the grid update);
  * ``frozen``: 4 guided waves of 8 spp through trace_fused with the
    trained grid, camera rays and splat included (the headline shape);
  * ``door_room_progression``: one guided progression (4 spp) of the
    default door_room() (244838 triangles) at 512x512, every query through
    the pair pipeline and the blocklist fallback; a second line gives its
    wave count and device operations per wave.

For each window it prints one JSON line: the wall time, the device time
(the profiler's device-side events, kernels, copies and memsets, each
counted once), the device's idle share (1 - device / wall), the number of
device operations, the ten with the most device time and the eight host
operations with the most host time.  With ``--trace DIR`` it also writes
each window's Chrome trace there (tens of MB).  ``--device cpu``
rehearses the script on the CPU, where no device time exists.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _window(name, fn, dev, trace_dir):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    dev_ops = [a for a in avgs if a.device_type == DeviceType.CUDA]
    busy_us = sum(a.self_device_time_total for a in dev_ops)
    top = sorted(dev_ops, key=lambda a: a.self_device_time_total, reverse=True)[:10]
    host = sorted(avgs, key=lambda a: a.self_cpu_time_total, reverse=True)[:8]
    if trace_dir:
        prof.export_chrome_trace(os.path.join(trace_dir, f"{name}.json"))
    rec = {
        "window": name, "device": str(dev), "wall_ms": wall_us / 1e3,
        "device_ms": busy_us / 1e3 if dev.type == "cuda" else None,
        "idle_share": 1.0 - busy_us / wall_us if dev.type == "cuda" else None,
        "device_ops": sum(a.count for a in dev_ops),
        "top": [{"name": a.key[:80], "count": a.count,
                 "device_ms": a.self_device_time_total / 1e3} for a in top],
        "top_host": [{"name": a.key[:80], "count": a.count,
                      "host_ms": a.self_cpu_time_total / 1e3} for a in host],
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--trace", default=None, help="directory for Chrome traces")
    ap.add_argument("--device", default=None)
    ap.add_argument("--door-res", type=int, default=512)
    ap.add_argument("--door-tris", type=int, default=0,
                    help="door_room triangle budget (0: the default scene)")
    args = ap.parse_args(argv)
    import torch

    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.core.device import resolve_device
    from mitsuba_path_guiding_torch.film.film import splat_box_aligned
    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_torch.integrators.render import PIXEL_BATCH, RenderConfig
    from mitsuba_path_guiding_torch.models.sensor import generate_rays
    from mitsuba_path_guiding_torch.ops import build
    from mitsuba_path_guiding_torch.ops.fused_path import build_fused_tables, trace_fused
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box, door_room

    dev = resolve_device(args.device)
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
    if dev.type == "cuda":
        build.build_all()
        smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read()
        print(smi.strip().splitlines()[0], flush=True)
    w = h = args.res
    scene = build_scene(cornell_box(), device=dev)
    cfg = ProgressiveConfig(render=RenderConfig(width=w, height=h, spp=0, max_depth=5),
                            samples_per_progression=4, n_progressions=1, guiding=True,
                            grid_res=16, n_lobes=8)
    renderer = ProgressiveRenderer(scene, cfg)
    renderer.run_progression()                       # warm-up, untraced
    _window("progressive", renderer.run_progression, dev, args.trace)

    tables = build_fused_tables(scene)
    n_pix = w * h
    rgbw = torch.zeros((n_pix, 4), device=dev)

    def frozen(waves=4, spp=8):
        for wave in range(waves):
            pix = torch.arange(n_pix, device=dev).repeat(spp)
            sidx = torch.arange(spp, device=dev).repeat_interleave(n_pix) + 100 + spp * wave
            rkeys = rng.ray_keys(rng.base_key(0, device=dev), pix, sidx)
            u_cam = rng.event_uniform(rkeys, rng.TAG_CAMERA, 2)
            o, d, _ = generate_rays(scene.sensor, w, h, pix, u_cam)
            L, _, _ = trace_fused(tables, o, d, rkeys, grid=renderer.grid, max_depth=5,
                                  guided=True, alpha=0.5)
            splat_box_aligned(rgbw, L, n_pix)

    frozen(1)                                        # warm-up, untraced
    _window("frozen", frozen, dev, args.trace)

    # door_room(): one guided progression of the pair pipeline's route
    door = build_scene(door_room(args.door_tris) if args.door_tris else door_room(), device=dev)
    r = args.door_res
    dcfg = ProgressiveConfig(render=RenderConfig(width=r, height=r, spp=0, max_depth=5),
                             samples_per_progression=4, n_progressions=1, guiding=True,
                             grid_res=16, n_lobes=8)
    door_renderer = ProgressiveRenderer(door, dcfg)
    door_renderer.run_progression()                  # warm-up, untraced
    waves = -(-r * r // PIXEL_BATCH) * dcfg.samples_per_progression
    rec = _window("door_room_progression", door_renderer.run_progression, dev, args.trace)
    print(json.dumps({"window": "door_room_progression", "waves": waves,
                      "device_ops_per_wave": rec["device_ops"] / waves,
                      "triangles": int(door.geo.p0.shape[0]), "resolution": f"{r}x{r}"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
