#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Builds the port's CUDA kernels from ``mitsuba_path_guiding_torch/csrc``
(one nvcc per source, in parallel), holds each kernel against its plain
PyTorch version at the main path's shapes, drives the main path through
the entry points a user calls, and times every kernel.  Each phase prints
one JSON line; any failed check raises, so the script exits non-zero.
The last line is the device record
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Phases:
  1. card name and power limit (nvidia-smi), kernel build and ptxas report;
  2. gather_rows_t (R in {36, 512}, C=32, N=524288, indices outside [0, R)
     included; bit-equal) and intersect_tiled (524288 Cornell camera rays
     and 524288 random rays, closest and any-hit, mixed and negative tmax;
     prim equal on >= 99.99% of lanes, t/u/v within 1e-5 relative);
  3. the main path: ProgressiveRenderer on cornell_box() at 256x256,
     depth 5, 4 spp x 4 progressions, a 16^3 grid of 8 lobes, guiding on;
     the image must be finite, non-black, within 3% of the JAX reference
     mean below, and the grid must have valid cells;
  4. the frozen-cache render (256x256 x 8 spp per wave = 524288 lanes,
     16 waves, guided through trace_fused with the phase-3 grid) and the
     unguided render() at 256x256 x 16 spp (fused route); Mrays/s =
     2 * sum(n_bounces) / s.  Then trace_fused against its plain version
     at 256x256 x 1 spp, guided and unguided: L within rtol 1e-3 on >= 99%
     of lanes, image means within 0.5%;
  5. door_room() (244838 triangles): the build (pair and blocklist
     tables), then the kernel checks on 262144 camera rays of a 512x512
     wave and 262144 random rays: the MT and Pluecker pair tiles on their
     sorted pairs, closest and any-hit (t and prim equal on >= 99.99% of
     pairs, t within 1e-5 relative); the blocklist kernel on 16384 random
     rays, on all 262144 camera rays and with k=1 (overflow) on 16384
     random rays (prim equal on >= 99.99%, t/u/v within 1e-5, work counts
     equal on >= 99.9% of tiles); intersect_pairs_full (mt and plk) and
     occluded_pairs_full on 8192 rays of each set against the dense
     oracle (occlusion equal on every ray, prim on every ray but the
     known misses of DOOR_E2E_MISSES);
  6. the door_room main path: ProgressiveRenderer at 512x512, depth 5,
     4 spp x 2 progressions, a 16^3 grid of 8 lobes, guiding on; the image
     must be finite, non-black, within max(3%, 4 standard errors) of the
     JAX reference mean below, and the grid must have valid cells; then
     one wave of both queries through the Pluecker engine;
  7. CUDA-event timings (median of 7) of each kernel, its plain version
     and, where one exists, the one-call PyTorch yardstick; the "kernels"
     line with bounds from this run's inputs.

Each main-path route runs with the launch counts set to 0 just before it
and read just after it, and is held to the kernels it must launch: the
Cornell progressive render to gather_rows_t and intersect_tiled, the
frozen-cache render and the unguided render() to one trace_fused per wave
(and nothing else), the door_room render to one pair-tile (MT) launch per
query (160) and one blocklist launch per query that left a ray unproven
(counted in the same run, ``count_retraces``), the Pluecker wave likewise.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

# Image mean of the built-in Cornell box, unguided, 128x128 x 64 spp,
# depth 5: 0.11478 +- 0.00021 (standard error), from the JAX package on
# the CPU by tools/cornell_reference_mean.py.
CORNELL_REFERENCE_MEAN = 0.11478328797966242
MEAN_TOL = 0.03

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and FP32 operations/s
# outside the tensor cores.  The sheet's 67 TFLOP/s counts a fused
# multiply-add as two operations; the kernels build with -fmad=false, so
# every multiply and every add below is an instruction of its own, issued
# at half that rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
# FP32 operations read off the kernels' bodies (csrc/).  An add, subtract,
# multiply, divide, min, max or special function (sqrt, rsqrt, exp, log,
# sin, cos) counts one; compares, absolute values, negations and integer
# work count none.  Both operands of a ?: count, since straight-line code
# computes both; of an `if` block whose taking depends on the data the
# cheaper side counts, so the bound stays a lower one.
MT_OPS = 46               # device_math.cuh pg_mt_test: one (ray, triangle) test
PLK_CLOSEST_OPS = 52      # pg_plucker_hit, closest hit (with the eps slack)
PLK_ANY_OPS = 49          # pg_plucker_hit, any-hit
LOOP_OPS = 19             # fused_path.cu per bounce loop entered: 10 bits_to_unit, o x d
# fused_path.cu per bounce after the closest hit: the exact MT (45),
# shading point and normal, emissive MIS, frame, NEE sample and shadow
# ray set-up, NEE MIS, cosine sample, throughput (no roulette at
# rr_depth = max_depth, as here); guided adds the cell index, the
# mixture weights, two 8-lobe mixture pdfs and the one-sample MIS draw.
BOUNCE_OPS = {False: 289, True: 734}

GATE_OPS = 23    # intersect_blocklist.cu: one (ray, block box) gate
PLK_M_OPS = 9    # intersect_pairs.cu: m = o x d, once per pair

W = H = 256
DEPTH = 5
FROZEN_WAVES = 16  # bench.py's headline: 16 waves of 256x256 x 8 spp
RENDER_SPP = 16    # unguided render(): one fused wave per sample

# door_room(): 244838 triangles, rendered at bench.py's 512x512, 4 spp x 2
# progressions.  A wave is at most PIXEL_BATCH = 131072 pixels x 1 spp, so
# 16 waves; each bounce of each wave runs one closest-hit and one shadow
# query, each one pair-tile launch, and one blocklist launch if the query
# left a ray unproven.
DOOR_TRIS = 244838
DOOR_W = DOOR_H = 512
DOOR_SPP, DOOR_PROGRESSIONS = 4, 2
DOOR_WAVE = 131072
DOOR_WAVES = (DOOR_W * DOOR_H // DOOR_WAVE) * DOOR_SPP * DOOR_PROGRESSIONS
DOOR_QUERIES = 2 * DEPTH * DOOR_WAVES
DOOR_E2E_RAYS = 8192
# Rays of the 8192 lower-half camera rays whose proven pair result is not
# the nearest triangle, by engine; none of the random rays.  The lists
# slab-test unpadded block boxes, so a grazing hit just outside a block's
# box is dropped (one ray, the base of the dividing wall), and the Pluecker
# test is not watertight, so with engine "plk" one more ray slips between
# two sphere triangles.  The JAX pair route misses the same rays
# (tests/test_torch_door_room.py::test_pair_route_misses_what_the_reference_misses).
DOOR_E2E_MISSES = {"mt": 1, "plk": 2}
# Image mean of door_room(), unguided, 128x128 x 32 spp (8 groups of 4 spp,
# seeds 1000-1007), depth 5: 0.51385 +- 0.00311 (standard error over the
# groups), from the JAX package's BVH route on the CPU (independent of the
# pair and blocklist code) by tools/door_room_reference_mean.py.
DOOR_REFERENCE_MEAN = 0.5138526037335396
DOOR_REFERENCE_SE = 0.003108315952031836


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=7, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def camera_rays(scene, spp, sample_base, seed=0, w=W, h=H):
    """Pixel-aligned waves of spp planes (sample i -> pixel i % n_pix)."""
    import torch

    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.models.sensor import generate_rays

    dev = scene.geo.p0.device
    n_pix = w * h
    pix = torch.arange(n_pix, device=dev).repeat(spp)
    sidx = torch.arange(spp, device=dev).repeat_interleave(n_pix) + sample_base
    rkeys = rng.ray_keys(rng.base_key(seed, device=dev), pix, sidx)
    u_cam = rng.event_uniform(rkeys, rng.TAG_CAMERA, 2)
    o, d, _ = generate_rays(scene.sensor, w, h, pix, u_cam)
    return o, d, rkeys


def random_rays(scene, n, gen, mixed_tmax=True):
    """n rays from uniform points of the scene's box in uniform directions;
    with ``mixed_tmax`` a third each unbounded, short and dead."""
    import torch

    dev = scene.geo.p0.device
    lo, hi = scene.aabb_min, scene.aabb_max
    o = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=dev), dim=-1)
    tmax = torch.full((n,), 3.0e37, device=dev)
    if mixed_tmax:
        sel = torch.randint(0, 3, (n,), generator=gen, device=dev)
        tmax = torch.where(sel == 0, tmax, torch.where(
            sel == 1, 4.0 * torch.rand((n,), generator=gen, device=dev), -1.0))
    return o, d, tmax


def phase_build():
    from mitsuba_path_guiding_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.time()
    build.build_all()
    ptxas = {}
    for name in build.KERNEL_SOURCES:
        ptxas[name] = [ln.strip() for ln in build.build_log(name).splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "ptxas": ptxas})
    return smi


def phase_kernel_checks(scene):
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_brute, occluded_brute
    from mitsuba_path_guiding_torch.ops.gather import gather_rows_t, gather_rows_t_plain
    from mitsuba_path_guiding_torch.ops.intersect_tiled import intersect_tiled, pack_triangles

    dev = scene.geo.p0.device
    gen = torch.Generator(device=dev).manual_seed(1)
    n = 524288
    res = {}
    for r in (36, 512):
        table = torch.rand((r, 32), generator=gen, device=dev)
        for dtype in (torch.int64, torch.int32):
            idx = torch.randint(-5, r + 5, (n,), generator=gen, device=dev).to(dtype)
            got = gather_rows_t(table, idx)
            want = gather_rows_t_plain(table, idx)
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"gather_rows_t R={r} {dtype} not bit-equal")
    res["gather_rows_t"] = {"check": "bit-equal", "max_abs_err": 0.0}

    geo = scene.geo
    pack = pack_triangles(geo.p0, geo.e1, geo.e2)
    o_cam, d_cam, _ = camera_rays(scene, 8, 0)
    lo, hi = scene.aabb_min, scene.aabb_max
    o_rnd = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    d_rnd = torch.nn.functional.normalize(torch.randn((n, 3), generator=gen, device=dev), dim=-1)
    worst_frac, worst_rel, worst_abs = 1.0, 0.0, 0.0
    for label, o, d in (("camera", o_cam, d_cam), ("random", o_rnd, d_rnd)):
        sel = torch.randint(0, 3, (n,), generator=gen, device=dev)
        tmax = torch.where(sel == 0, 3.0e37, torch.where(
            sel == 1, 4.0 * torch.rand((n,), generator=gen, device=dev), -1.0))
        t, prim, u, v, valid = intersect_tiled(pack, o, d, tmax, geo.p0.shape[0])
        ref = intersect_brute(geo, o, d, tmax)
        occ = intersect_tiled(pack, o, d, tmax, geo.p0.shape[0], any_hit=True)
        occ_ref = occluded_brute(geo, o, d, tmax)
        torch.cuda.synchronize()
        same = prim == ref.prim
        frac = float(same.float().mean())
        both = same & valid
        rel = err = 0.0
        for a, b in ((t, ref.t), (u, ref.u), (v, ref.v)):
            diff = torch.abs(a[both] - b[both])
            rel = max(rel, float((diff / torch.clamp_min(torch.abs(b[both]), 1e-6)).max()))
            err = max(err, float(diff.max()))
        occ_frac = float((occ == occ_ref).float().mean())
        check(frac >= 0.9999, f"intersect_tiled {label}: prim equal on {frac}")
        check(rel <= 1e-5, f"intersect_tiled {label}: t/u/v rel err {rel}")
        check(occ_frac >= 0.9999, f"intersect_tiled any-hit {label}: agree on {occ_frac}")
        res[f"intersect_tiled_{label}"] = {"prim_equal": frac, "max_rel_err": rel,
                                           "max_abs_err": err, "any_hit_equal": occ_frac}
        worst_frac = min(worst_frac, frac, occ_frac)
        worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
    res["intersect_tiled"] = {
        "check": f"prim and any-hit equal on >= {worst_frac} of lanes, t/u/v rel err {worst_rel}",
        "max_abs_err": worst_abs}
    emit({"phase": "kernel_checks", **{k: v for k, v in res.items()
                                       if k not in ("gather_rows_t", "intersect_tiled")},
          "gather_rows_t": "bit-equal"})
    return res


def phase_progressive(scene):
    import torch

    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    cfg = ProgressiveConfig(render=RenderConfig(width=W, height=H, spp=0, max_depth=DEPTH),
                            samples_per_progression=4, n_progressions=4, guiding=True,
                            grid_res=16, n_lobes=8)
    renderer = ProgressiveRenderer(scene, cfg)
    torch.cuda.synchronize()
    t0 = time.time()
    img = renderer.render()
    torch.cuda.synchronize()
    dt = time.time() - t0
    mean = float(img.mean())
    n_valid = int(renderer.grid.valid.sum())
    check(bool(torch.isfinite(img).all()), "progressive image not finite")
    check(mean > 0.0, "progressive image is black")
    check(n_valid > 0, "guiding grid has no valid cells")
    rel = abs(mean - CORNELL_REFERENCE_MEAN) / CORNELL_REFERENCE_MEAN
    check(rel < MEAN_TOL, f"progressive mean {mean} vs reference {CORNELL_REFERENCE_MEAN}")
    segs = renderer.stats.get("rays traced") / 2
    emit({"phase": "progressive", "seconds": round(dt, 3), "mean": mean,
          "reference_mean": CORNELL_REFERENCE_MEAN, "rel_err": rel, "valid_cells": n_valid,
          "spp": renderer.sample_counter, "mrays_per_s": 2 * segs / dt / 1e6})
    return renderer.grid


def phase_frozen(scene, grid, card):
    import torch

    from mitsuba_path_guiding_torch.film.film import splat_box_aligned
    from mitsuba_path_guiding_torch.ops.fused_path import build_fused_tables, trace_fused

    tables = build_fused_tables(scene)
    n_pix = W * H
    rgbw = torch.zeros((n_pix, 4), device=scene.geo.p0.device)
    segs = torch.zeros((), dtype=torch.int64, device=rgbw.device)
    torch.cuda.synchronize()
    t0 = time.time()
    for wave in range(FROZEN_WAVES):
        o, d, rkeys = camera_rays(scene, 8, 16 + 8 * wave)
        L, aux, _ = trace_fused(tables, o, d, rkeys, grid=grid, max_depth=DEPTH,
                                guided=True, alpha=0.5)
        splat_box_aligned(rgbw, L, n_pix)
        segs += aux.n_bounces.sum()
    torch.cuda.synchronize()
    dt = time.time() - t0
    img = rgbw[:, 0:3] / torch.clamp_min(rgbw[:, 3:4], 1e-8)
    check(bool(torch.isfinite(img).all()), "frozen-cache image not finite")
    mean = float(img.mean())
    check(abs(mean - CORNELL_REFERENCE_MEAN) / CORNELL_REFERENCE_MEAN < MEAN_TOL,
          f"frozen-cache mean {mean}")
    emit({"phase": "frozen_render", "card": card, "waves": FROZEN_WAVES,
          "lanes_per_wave": 8 * n_pix, "seconds": round(dt, 4),
          "mrays_per_s": 2 * int(segs) / dt / 1e6, "mean": mean})
    return tables


def phase_unguided_render(scene, card):
    import torch

    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render

    torch.cuda.synchronize()
    t0 = time.time()
    img = render(scene, RenderConfig(width=W, height=H, spp=RENDER_SPP, max_depth=DEPTH))
    torch.cuda.synchronize()
    dt = time.time() - t0
    mean = float(img.mean())
    check(bool(torch.isfinite(img).all()), "unguided render not finite")
    check(abs(mean - CORNELL_REFERENCE_MEAN) / CORNELL_REFERENCE_MEAN < MEAN_TOL,
          f"unguided render mean {mean}")
    emit({"phase": "unguided_render", "card": card, "spp": RENDER_SPP,
          "seconds": round(dt, 4), "mean": mean})


def drive(name, fn, expect):
    """Run one main-path route with every launch count set to 0 just
    before it and read just after it.  ``expect`` maps each kernel to the
    count the route must give (or to a function of no arguments giving it
    once the route has run), or to None for "at least one"."""
    import torch

    from mitsuba_path_guiding_torch.ops import build

    build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)
    emit({"phase": "launches", "route": name, **counts})
    for kernel, want in expect.items():
        got = counts[kernel]
        want = want() if callable(want) else want
        if want is None:
            check(got > 0, f"{name}: {kernel} was not launched")
        else:
            check(got == want, f"{name}: {kernel} launched {got} times, expected {want}")
    return out, counts


def phase_fused_check(scene, tables, grid):
    import torch

    from mitsuba_path_guiding_torch.ops.fused_path import (
        _pack_guide,
        trace_fused_cuda,
        trace_fused_plain,
    )

    o, d, rkeys = camera_rays(scene, 1, 1000)
    guide_tab, meta = _pack_guide(grid)
    out = {}
    worst = 0.0
    for guided in (False, True):
        kw = dict(max_depth=DEPTH, rr_depth=5, guided=guided, alpha=0.5)
        got = trace_fused_cuda(tables, o, d, rkeys, guide_tab, meta, **kw)
        want = trace_fused_plain(tables, o, d, rkeys, guide_tab, meta, **kw)
        torch.cuda.synchronize()
        Lg, Lw = got[0:3].T, want[0:3].T
        close = torch.isclose(Lg, Lw, rtol=1e-3, atol=1e-6).all(dim=-1)
        frac = float(close.float().mean())
        mg, mw = float(Lg.mean()), float(Lw.mean())
        rel_mean = abs(mg - mw) / max(mw, 1e-12)
        err = float((Lg - Lw).abs().max())
        # rows 14-15, the work counts the bound is computed from
        work = float((got[14:16] == want[14:16]).all(dim=0).float().mean())
        check(frac >= 0.99, f"trace_fused guided={guided}: L close on {frac}")
        check(rel_mean < 0.005, f"trace_fused guided={guided}: means {mg} vs {mw}")
        check(work >= 0.99, f"trace_fused guided={guided}: work counts equal on {work}")
        out["guided" if guided else "unguided"] = {"frac_close": frac, "work_equal": work,
                                                   "mean": mg, "plain_mean": mw,
                                                   "max_abs_err": err}
        worst = max(worst, err)
    emit({"phase": "fused_check", **out})
    return {"check": "L rtol 1e-3 on >= 99% of lanes, means within 0.5%",
            "max_abs_err": worst, "frac_close": min(v["frac_close"] for v in out.values())}


def phase_timings(scene, tables, grid, checks, launches, card):
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_brute
    from mitsuba_path_guiding_torch.ops.fused_path import (
        _pack_guide,
        trace_fused_cuda,
        trace_fused_plain,
    )
    from mitsuba_path_guiding_torch.ops.gather import gather_rows_t_cuda, gather_rows_t_plain
    from mitsuba_path_guiding_torch.ops.intersect_tiled import intersect_tiled_cuda, pack_triangles

    dev = scene.geo.p0.device
    n_pix = W * H
    entries = []
    # gather: the main path's shading-row fetch, (36, 32) table x 65536 lanes
    geo = scene.geo
    table = geo.shade_packed
    idx = torch.randint(0, table.shape[0], (n_pix,), device=dev, dtype=torch.int32)
    ms = cuda_ms(lambda: gather_rows_t_cuda(table, idx))
    plain = cuda_ms(lambda: gather_rows_t_plain(table, idx).contiguous())
    lib = cuda_ms(lambda: torch.index_select(table, 0, idx).T.contiguous())
    r, c = table.shape
    b_ms, b_by = bound(r * c * 4 + n_pix * 4 + c * n_pix * 4, 0)
    entries.append({
        "name": "gather_rows_t", "route": "cuda",
        "source": "mitsuba_path_guiding_torch/csrc/gather_rows.cu",
        "replaces": "mitsuba_path_guiding_tpu/ops/gather_pallas.py:32",
        "launches": sum(launches["gather_rows_t"].values()),
        "launches_by_route": launches["gather_rows_t"],
        "max_abs_err": checks["gather_rows_t"]["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"table {r}x{c} f32, {n_pix} int32 indices", "check": "bit-equal"})

    # intersect_tiled: one closest-hit wave of 65536 camera rays
    o, d, _ = camera_rays(scene, 1, 2000)
    tmax = torch.full((n_pix,), 3.0e37, device=dev)
    pack = pack_triangles(geo.p0, geo.e1, geo.e2)
    n_tri = geo.p0.shape[0]
    ms = cuda_ms(lambda: intersect_tiled_cuda(pack, o, d, tmax, n_tri))
    plain = cuda_ms(lambda: intersect_brute(geo, o, d, tmax))
    b_ms, b_by = bound(pack.numel() * 4 + n_pix * 44, n_pix * n_tri * MT_OPS)
    entries.append({
        "name": "intersect_tiled", "route": "cuda",
        "source": "mitsuba_path_guiding_torch/csrc/intersect_tiled.cu",
        "replaces": "mitsuba_path_guiding_tpu/ops/intersect_pallas.py:30",
        "launches": sum(launches["intersect_tiled"].values()),
        "launches_by_route": launches["intersect_tiled"],
        "max_abs_err": checks["intersect_tiled"]["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"{n_pix} rays x {n_tri} triangles, closest hit",
        "check": checks["intersect_tiled"]["check"]})

    # trace_fused: one guided frozen-cache wave, 256x256 x 8 spp.  Its
    # output rows 14 and 15 count the work this run's data needed: the
    # bounce loops each lane entered and the triangles its shadow rays
    # tested before their first occluder.
    o, d, rkeys = camera_rays(scene, 8, 3000)
    guide_tab, meta = _pack_guide(grid)
    kw = dict(max_depth=DEPTH, rr_depth=5, guided=True, alpha=0.5)
    out = trace_fused_cuda(tables, o, d, rkeys, guide_tab, meta, **kw)
    segs = int(out[10].sum())
    loops = int(out[14].sum())
    shadow_tests = int(out[15].sum())
    ms = cuda_ms(lambda: trace_fused_cuda(tables, o, d, rkeys, guide_tab, meta, **kw))
    plain = cuda_ms(lambda: trace_fused_plain(tables, o, d, rkeys, guide_tab, meta, **kw), reps=5)
    n = o.shape[0]
    table_bytes = sum(t.numel() * t.element_size() for t in (
        tables.plk_rows, tables.shade_rows, tables.em_rows, tables.mat_rows, guide_tab, meta))
    ops = (loops * (n_tri * PLK_CLOSEST_OPS + LOOP_OPS) + shadow_tests * PLK_ANY_OPS
           + segs * BOUNCE_OPS[True])
    b_ms, b_by = bound(table_bytes + n * (24 + 8 + 64), ops)
    entries.append({
        "name": "trace_fused", "route": "cuda",
        "source": "mitsuba_path_guiding_torch/csrc/fused_path.cu",
        "replaces": "mitsuba_path_guiding_tpu/ops/fused_path.py:326",
        "launches": sum(launches["trace_fused"].values()),
        "launches_by_route": launches["trace_fused"],
        "max_abs_err": checks["trace_fused"]["max_abs_err"],
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"{n} lanes, depth {DEPTH}, guided, {segs} path segments",
        "work": {"bounce_loops": loops, "shadow_triangle_tests": shadow_tests,
                 "fp32_ops": ops},
        "mrays_per_s": 2 * segs / ms / 1e3, "check": checks["trace_fused"]["check"],
        "frac_close": checks["trace_fused"]["frac_close"]})
    emit({"phase": "timings", "card": card,
          "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30})
    return entries


# ---------------------------------------------------------------------------
# door_room: the pair pipeline and the blocklist fallback
# ---------------------------------------------------------------------------

def _bytes(tables):
    return sum(x.numel() * x.element_size() for x in tables if hasattr(x, "numel"))


def phase_door_build():
    import torch

    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    t0 = time.time()
    scene = build_scene(door_room(), device="cuda")
    torch.cuda.synchronize()
    n_tri = scene.geo.p0.shape[0]
    check(n_tri == DOOR_TRIS, f"door_room compiled to {n_tri} triangles")
    check(scene.pairs is not None and scene.blocks is not None, "door_room has no pair tables")
    emit({"phase": "door_room_build", "seconds": round(time.time() - t0, 3), "triangles": n_tri,
          "pair_blocks": scene.pairs.tri_rows.shape[0],
          "pair_superblocks": scene.pairs.sb_lo.shape[0],
          "blocklist_superblocks": scene.blocks.sb_lo.shape[0],
          "pair_table_bytes": _bytes(scene.pairs), "blocklist_bytes": _bytes(scene.blocks)})
    return scene


def _rel(a, b, mask):
    if not bool(mask.any()):
        return 0.0, 0.0
    diff = (a[mask] - b[mask]).abs()
    return (float((diff / b[mask].abs().clamp_min(1e-6)).max()), float(diff.max()))


def brute_chunked(geo, o, d, tmax, any_hit=False, chunk=4096):
    """The dense oracle over triangle chunks in ascending id (a strictly
    nearer hit replaces the best, so ties keep the lowest id): (t, prim),
    or the occlusion mask with ``any_hit``."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_tiled import any_plain, closest_plain

    n_tri = geo.p0.shape[0]
    parts = ((geo.p0[a:a + chunk], geo.e1[a:a + chunk], geo.e2[a:a + chunk], a)
             for a in range(0, n_tri, chunk))
    if any_hit:
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for p0, e1, e2, _ in parts:
            occ |= any_plain(p0, e1, e2, o, d, tmax)
        return occ
    prim = torch.full((o.shape[0],), -1, dtype=torch.int32, device=o.device)
    best = torch.full((o.shape[0],), 3.0e38, device=o.device)
    for p0, e1, e2, a in parts:
        t, p, _, _, valid = closest_plain(p0, e1, e2, o, d, tmax)
        take = valid & (t < best)
        best = torch.where(take, t, best)
        prim = torch.where(take, p + a, prim)
    return best, prim


def _pair_set(scene, o, d, tmax):
    from mitsuba_path_guiding_torch.integrators.path import PAIR_CAP
    from mitsuba_path_guiding_torch.ops.intersect_pairs import (
        build_pair_lists,
        pair_tiles,
        sorted_pairs,
    )

    ids, _ = build_pair_lists(scene.pairs, o, d, tmax)
    skeys, spays, _ = sorted_pairs(scene.pairs, ids, o.shape[0], PAIR_CAP)
    return pair_tiles(skeys, spays, o, d, tmax)


def phase_door_kernel_checks(scene):
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pairs_full, occluded_pairs_full
    from mitsuba_path_guiding_torch.integrators.path import PAIR_CAP
    from mitsuba_path_guiding_torch.ops.intersect_blocklist import (
        _pad_rays,
        blocklist_cuda,
        blocklist_plain,
        cand_width,
        candidate_superblocks,
    )
    from mitsuba_path_guiding_torch.ops.intersect_pairs import (
        INF,
        intersect_pairs_raw,
        mt_tiles,
        mt_tiles_plain,
        plk_tiles,
        plk_tiles_plain,
    )

    t0 = time.time()
    dev = scene.geo.p0.device
    gen = torch.Generator(device=dev).manual_seed(2)
    n = DOOR_W * DOOR_H
    o_cam, d_cam, _ = camera_rays(scene, 1, 0, w=DOOR_W, h=DOOR_H)
    sets = {"camera": (o_cam, d_cam, torch.full((n,), 3.0e37, device=dev)),
            "random": random_rays(scene, n, gen)}
    pt, bl = scene.pairs, scene.blocks
    res = {"pairs_mt": {}, "pairs_plk": {}, "blocklist": {}, "end_to_end": {}}
    worst = {"pairs_mt": 0.0, "pairs_plk": 0.0, "blocklist": 0.0}

    # tiles: kernel against plain version on the sorted pairs
    for label, (o, d, tmax) in sets.items():
        pdata, tile_block = _pair_set(scene, o, d, tmax)
        for engine, kern, plain, tabs in (
                ("pairs_mt", mt_tiles, mt_tiles_plain, (pt.tri_rows,)),
                ("pairs_plk", plk_tiles, plk_tiles_plain, (pt.tri_cols, pt.tri_rows))):
            for any_hit in (False, True):
                got = kern(*tabs, tile_block, pdata, any_hit)
                want = plain(*tabs, tile_block, pdata, any_hit)
                torch.cuda.synchronize()
                t_eq = float((got[0] == want[0]).float().mean())
                p_eq = float((got[1] == want[1]).float().mean())
                rel, err = _rel(got[0], want[0], (got[0] < INF) & (want[0] < INF))
                what = f"{engine} {label} any_hit={any_hit}"
                check(t_eq >= 0.9999 and p_eq >= 0.9999, f"{what}: t/prim equal on {t_eq}/{p_eq}")
                check(rel <= 1e-5, f"{what}: t rel err {rel}")
                res[engine][f"{label}_{'any' if any_hit else 'closest'}"] = {
                    "pairs": pdata.shape[1], "live_tiles": int((tile_block >= 0).sum()),
                    "t_equal": t_eq, "prim_equal": p_eq, "max_rel_err": rel}
                worst[engine] = max(worst[engine], err)

    # blocklist: the fallback-sized call on random rays, a full wave of
    # camera rays, and a k=1 (overflow) call
    calls = (("fallback_random", sets["random"], n // 16, 128),
             ("full_camera", sets["camera"], n, 128),
             ("overflow_random", sets["random"], n // 16, 1))
    for label, (o, d, tmax), m, k in calls:
        o_p, d_p, t_p, npad = _pad_rays(o[:m], d[:m], tmax[:m])
        kw = cand_width(npad, bl.sb_lo.shape[0], k)
        cand, cnt = candidate_superblocks(bl.sb_lo, bl.sb_hi, o_p, d_p, t_p, kw)
        for any_hit in (False, True):
            got, gw = blocklist_cuda(bl, o_p, d_p, t_p, cand, cnt, any_hit)
            want, ww = blocklist_plain(bl, o_p, d_p, t_p, cand, cnt, any_hit)
            torch.cuda.synchronize()
            p_eq = float((got[1, :m] == want[1, :m]).float().mean())
            w_eq = float((gw == ww).all(dim=1).float().mean())
            valid = (want[1, :m] >= 0) & (got[1, :m] == want[1, :m]) & (want[0, :m] < INF)
            rel, err = 0.0, 0.0
            if not any_hit:
                for r in range(3):
                    rr, ee = _rel(got[r, :m], want[r, :m], valid)
                    rel, err = max(rel, rr), max(err, ee)
            what = f"blocklist {label} any_hit={any_hit}"
            check(p_eq >= 0.9999, f"{what}: prim equal on {p_eq}")
            check(rel <= 1e-5, f"{what}: t/u/v rel err {rel}")
            check(w_eq >= 0.999, f"{what}: work counts equal on {w_eq} of tiles")
            res["blocklist"][f"{label}_{'any' if any_hit else 'closest'}"] = {
                "rays": m, "k": kw, "overflow_tiles": int((cnt > kw).sum()),
                "prim_equal": p_eq, "work_equal": w_eq, "max_rel_err": rel,
                "superblocks_walked": int(gw[:, 0].sum()), "visits": int(gw[:, 1].sum())}
            worst["blocklist"] = max(worst["blocklist"], err)

    # end to end against the dense oracle: random rays, and camera rays of
    # the image's lower half (spheres and floor), whose lists the pair
    # compaction cuts most
    m = DOOR_E2E_RAYS
    for label, (o, d, tmax) in sets.items():
        a = 3 * n // 4 if label == "camera" else 0
        o, d, tmax = o[a:a + m], d[a:a + m], tmax[a:a + m]
        t_ref, prim_ref = brute_chunked(scene.geo, o, d, tmax)
        occ_ref = brute_chunked(scene.geo, o, d, tmax, any_hit=True)
        row = {}
        for engine in ("mt", "plk"):
            kw = dict(cap_factor=PAIR_CAP, engine=engine)
            hit = intersect_pairs_full(pt, bl, o, d, tmax, **kw)
            occ = occluded_pairs_full(pt, bl, o, d, tmax, **kw)
            proven = intersect_pairs_raw(pt, o, d, tmax, **kw)[-1]
            torch.cuda.synchronize()
            missed = int((hit.prim != prim_ref).sum())
            o_missed = int((occ != occ_ref).sum())
            allowed = DOOR_E2E_MISSES[engine] if label == "camera" else 0
            bad = torch.nonzero(hit.prim != prim_ref).flatten()[:4]
            check(missed <= allowed and o_missed == 0,
                  f"pairs_full {engine} {label}: {missed} prim misses (allowed {allowed}), "
                  f"{o_missed} occlusion misses; t {hit.t[bad].tolist()} vs "
                  f"{t_ref[bad].tolist()}, prim {hit.prim[bad].tolist()} vs "
                  f"{prim_ref[bad].tolist()}, proven {proven[bad].tolist()}")
            row[engine] = {"prim_misses": missed, "allowed": allowed,
                           "occlusion_misses": o_missed,
                           "proven_share": float(proven.float().mean()),
                           "unproven_retraced": int((~proven).sum())}
        res["end_to_end"][label] = row
    emit({"phase": "door_room_kernel_checks", "seconds": round(time.time() - t0, 3), **res})
    return {k: {"max_abs_err": v} for k, v in worst.items()}


def count_retraces(fn, route):
    """Run ``fn`` with ``accel.traverse._retrace`` wrapped, counting the pair
    queries whose unproven rays the blocklist kernel must re-trace (one
    launch each).  Returns (fn's result, that count)."""
    from mitsuba_path_guiding_torch.accel import traverse

    real = traverse._retrace
    unproven = []

    def counted(proven):
        idx = real(proven)
        unproven.append(idx.numel())
        return idx

    traverse._retrace = counted
    try:
        out = fn()
    finally:
        traverse._retrace = real
    n = sum(1 for u in unproven if u)
    emit({"phase": "retraces", "route": route, "pair_queries": len(unproven),
          "queries_with_unproven": n, "unproven_min": min(unproven),
          "unproven_max": max(unproven), "unproven_total": sum(unproven)})
    return out, n


def phase_door_progressive(scene):
    import torch

    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_torch.integrators.render import PIXEL_BATCH, RenderConfig

    cfg = ProgressiveConfig(render=RenderConfig(width=DOOR_W, height=DOOR_H, spp=0,
                                                max_depth=DEPTH),
                            samples_per_progression=DOOR_SPP, n_progressions=DOOR_PROGRESSIONS,
                            guiding=True, grid_res=16, n_lobes=8)
    check(PIXEL_BATCH == DOOR_WAVE, f"waves of {PIXEL_BATCH} pixels, expected {DOOR_WAVE}")
    renderer = ProgressiveRenderer(scene, cfg)
    # the image mean after each progression (equal spp each), for the
    # render's own standard error
    prog_means = []
    run = renderer.run_progression

    def run_and_record():
        run()
        rgbw = renderer.film.rgb_weight
        prog_means.append(float((rgbw[:, 0:3] / rgbw[:, 3:4].clamp_min(1e-8)).mean()))

    renderer.run_progression = run_and_record
    torch.cuda.synchronize()
    t0 = time.time()
    img = renderer.render()
    torch.cuda.synchronize()
    dt = time.time() - t0
    mean = float(img.mean())
    n_valid = int(renderer.grid.valid.sum())
    check(bool(torch.isfinite(img).all()), "door_room image not finite")
    check(mean > 0.0, "door_room image is black")
    check(n_valid > 0, "door_room guiding grid has no valid cells")
    halves = [prog_means[0], DOOR_PROGRESSIONS * prog_means[-1] - prog_means[0]]
    se_card = abs(halves[0] - halves[1]) / 2.0
    tol = max(MEAN_TOL, 4.0 * (DOOR_REFERENCE_SE**2 + se_card**2) ** 0.5 / DOOR_REFERENCE_MEAN)
    rel = abs(mean - DOOR_REFERENCE_MEAN) / DOOR_REFERENCE_MEAN
    check(rel < tol, f"door_room mean {mean} vs reference {DOOR_REFERENCE_MEAN} (tol {tol})")
    segs = renderer.stats.get("rays traced") / 2
    emit({"phase": "door_room_progressive", "seconds": round(dt, 3), "mean": mean,
          "reference_mean": DOOR_REFERENCE_MEAN, "rel_err": rel, "rel_tol": tol,
          "se_card": se_card, "progression_means": prog_means, "valid_cells": n_valid,
          "spp": renderer.sample_counter, "mrays_per_s": 2 * segs / dt / 1e6})


def phase_door_plk(scene):
    """One wave through the Pluecker engine of both queries."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pairs_full, occluded_pairs_full
    from mitsuba_path_guiding_torch.integrators.path import PAIR_CAP

    o, d, _ = camera_rays(scene, 1, 7, w=DOOR_W, h=DOOR_H)
    o, d = o[:DOOR_WAVE], d[:DOOR_WAVE]
    kw = dict(cap_factor=PAIR_CAP, engine="plk")
    hit = intersect_pairs_full(scene.pairs, scene.blocks, o, d, torch.full_like(o[:, 0], 3.0e37),
                               **kw)
    # shadow rays to just past each camera hit: occluded exactly where hit
    occ = occluded_pairs_full(scene.pairs, scene.blocks, o, d,
                              torch.where(hit.valid, hit.t * 1.001, -1.0), **kw)
    torch.cuda.synchronize()
    agree = float((occ == hit.valid).float().mean())
    check(float(hit.valid.float().mean()) > 0.5, "plk route: camera rays hit nothing")
    check(agree >= 0.9999, f"plk route: occlusion agrees with the hits on {agree}")
    emit({"phase": "door_room_plk_route", "hit_share": float(hit.valid.float().mean()),
          "occluded_equals_hit": agree})


def phase_door_timings(scene, checks, launches):
    """CUDA-event medians of the three pair-pipeline kernels at the main
    path's shapes: the second camera wave (pixels 131072-262143 of 512x512)
    gives the tile kernels its sorted pairs; the blocklist runs the
    fallback of that wave's first bounce and of the wave itself.  Each
    bound counts the triangle tests this run's data needs: for the tiles,
    per live tile the pairs that can still hit (t range above EPS_T) times
    the real triangles of its block; for the blocklist, the kernel's own
    count of them (its work row 2)."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import _retrace, intersect_pairs_full
    from mitsuba_path_guiding_torch.integrators.path import PAIR_CAP
    from mitsuba_path_guiding_torch.ops.intersect_blocklist import (
        RAY_TILE,
        SB_BLOCKS,
        _pad_rays,
        blocklist_cuda,
        blocklist_plain,
        cand_width,
        candidate_superblocks,
    )
    from mitsuba_path_guiding_torch.ops.intersect_pairs import (
        EPS_T,
        TILE,
        intersect_pairs_raw,
        mt_tiles,
        mt_tiles_plain,
        plk_tiles,
        plk_tiles_plain,
    )

    pt, bl = scene.pairs, scene.blocks
    o, d, _ = camera_rays(scene, 1, 9, w=DOOR_W, h=DOOR_H)
    o, d = o[DOOR_WAVE:2 * DOOR_WAVE], d[DOOR_WAVE:2 * DOOR_WAVE]
    tmax = torch.full((DOOR_WAVE,), 3.0e37, device=o.device)
    pdata, tile_block = _pair_set(scene, o, d, tmax)
    live = int((tile_block >= 0).sum())
    blocks_used = int(torch.unique(tile_block[tile_block >= 0]).numel())
    n_pairs = pdata.shape[1]
    # dead and dummy pairs carry tmax 0, padding triangles id -1
    can_hit = (pdata[6] > EPS_T).reshape(-1, TILE).sum(dim=1)
    real_tris = (pt.tri_rows[tile_block.clamp_min(0).long(), 9, :] >= 0).sum(dim=1)
    tests = int(torch.where(tile_block >= 0, can_hit * real_tris, 0).sum())
    hit_pairs = int(can_hit.sum())
    io_bytes = n_pairs * (7 + 2) * 4 + tile_block.numel() * 4
    no_library = ("none: no single PyTorch call computes a per-pair best hit over a "
                  "gathered triangle block")
    entries = []
    for name, kern, plain, tabs, row_bytes, ops in (
            ("intersect_pairs_mt", mt_tiles, mt_tiles_plain, (pt.tri_rows,), 10 * TILE * 4,
             tests * MT_OPS),
            ("intersect_pairs_plk", plk_tiles, plk_tiles_plain, (pt.tri_cols, pt.tri_rows),
             26 * TILE * 4, tests * PLK_CLOSEST_OPS + hit_pairs * PLK_M_OPS)):
        ms = cuda_ms(lambda: kern(*tabs, tile_block, pdata, False))
        plain_ms = cuda_ms(lambda: plain(*tabs, tile_block, pdata, False), reps=3, warmup=1)
        b_ms, b_by = bound(io_bytes + blocks_used * row_bytes, ops)
        entries.append({
            "name": name, "route": "cuda",
            "source": "mitsuba_path_guiding_torch/csrc/intersect_pairs.cu",
            "replaces": ("mitsuba_path_guiding_tpu/ops/intersect_pairs.py:223" if name.endswith("mt")
                         else "mitsuba_path_guiding_tpu/ops/intersect_pairs.py:426"),
            "launches": sum(launches[name].values()), "launches_by_route": launches[name],
            "max_abs_err": checks[name.replace("intersect_", "")]["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "library": no_library,
            "shape": f"{DOOR_WAVE} camera rays: {n_pairs} sorted pairs, {live} live tiles of "
                     f"{TILE}, {blocks_used} distinct blocks, closest hit",
            "work": {"pairs_that_can_hit": hit_pairs, "triangle_tests": tests, "fp32_ops": ops},
            "check": "t and prim equal on >= 99.99% of pairs, t rel err <= 1e-5"})

    # the blocklist on two fallback calls of the main path: the camera
    # wave's, and a first bounce's (diffuse directions from the camera
    # hits), whose unproven rays are incoherent
    hit = intersect_pairs_full(pt, bl, o, d, tmax, cap_factor=PAIR_CAP)
    side = torch.sign((scene.geo.shade_packed[hit.prim.clamp_min(0).long(), 0:3] * -d)
                      .sum(-1, keepdim=True))
    ng = scene.geo.shade_packed[hit.prim.clamp_min(0).long(), 0:3] * side
    gen = torch.Generator(device=o.device).manual_seed(4)
    w = torch.nn.functional.normalize(torch.randn(o.shape, generator=gen, device=o.device), dim=-1)
    w = torch.where((w * ng).sum(-1, keepdim=True) < 0, -w, w)
    o2 = o + torch.where(hit.valid, hit.t, 1.0)[:, None] * d + ng * 1e-4
    t2 = torch.where(hit.valid, 3.0e37, -1.0)
    calls = {}
    for label, (oo, dd, tt) in (("bounce", (o2, w, t2)), ("camera", (o, d, tmax))):
        proven = intersect_pairs_raw(pt, oo, dd, tt, cap_factor=PAIR_CAP)[-1]
        idx = _retrace(proven)
        o_p, d_p, t_p, npad = _pad_rays(oo[idx], dd[idx], tt[idx])
        kw = cand_width(npad, bl.sb_lo.shape[0])
        cand, cnt = candidate_superblocks(bl.sb_lo, bl.sb_hi, o_p, d_p, t_p, kw)
        args = (bl, o_p, d_p, t_p, cand, cnt)
        _, work = blocklist_cuda(*args)
        walked, visits, tests = (int(x) for x in work.sum(dim=0))
        ops = walked * RAY_TILE * SB_BLOCKS * GATE_OPS + tests * MT_OPS
        # rays in (o, d, tmax), t/prim/u/v out, the candidate table; the
        # block tables are not counted (a lower bound)
        b_ms, b_by = bound(npad * (7 + 4) * 4 + cand.numel() * 4 + cnt.numel() * 4, ops)
        calls[label] = {
            "ms": cuda_ms(lambda: blocklist_cuda(*args)),
            "plain_ms": cuda_ms(lambda: blocklist_plain(*args), reps=1, warmup=0),
            "bound_ms": b_ms, "bound_by": b_by, "rays": npad,
            "unproven": int((~proven).sum()), "k": kw,
            "work": {"superblocks_walked": walked, "block_visits": visits,
                     "triangle_tests": tests, "fp32_ops": ops}}
    main_call = calls["bounce"]
    entries.append({
        "name": "intersect_blocklist", "route": "cuda",
        "source": "mitsuba_path_guiding_torch/csrc/intersect_blocklist.cu",
        "replaces": "mitsuba_path_guiding_tpu/ops/intersect_blocklist.py:130",
        "launches": sum(launches["intersect_blocklist"].values()),
        "launches_by_route": launches["intersect_blocklist"],
        "max_abs_err": checks["blocklist"]["max_abs_err"],
        "ms": main_call["ms"], "plain_ms": main_call["plain_ms"],
        "bound_ms": main_call["bound_ms"], "bound_by": main_call["bound_by"],
        "library_ms": None, "library": "none: no single PyTorch call walks candidate lists "
                                       "with early exit",
        "shape": f"fallback of a first bounce of the second {DOOR_WAVE}-ray camera wave: "
                 f"{main_call['rays']} rays ({main_call['unproven']} unproven), "
                 f"k={main_call['k']}",
        "work": main_call["work"], "calls": calls,
        "check": "prim equal on >= 99.99% of rays, t/u/v rel err <= 1e-5, work counts equal"})
    return entries


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_build()
    scene = build_scene(cornell_box(), device="cuda")
    checks = phase_kernel_checks(scene)

    no_pairs = {"intersect_pairs_mt": 0, "intersect_pairs_plk": 0, "intersect_blocklist": 0}
    only_fused = {"gather_rows_t": 0, "intersect_tiled": 0, **no_pairs}
    grid, c_prog = drive("progressive", lambda: phase_progressive(scene),
                         {"gather_rows_t": None, "intersect_tiled": None, "trace_fused": 0,
                          **no_pairs})
    tables, c_frozen = drive("frozen_render", lambda: phase_frozen(scene, grid, card),
                             {**only_fused, "trace_fused": FROZEN_WAVES})
    _, c_render = drive("unguided_render", lambda: phase_unguided_render(scene, card),
                        {**only_fused, "trace_fused": RENDER_SPP})

    checks["trace_fused"] = phase_fused_check(scene, tables, grid)

    door = phase_door_build()
    checks.update(phase_door_kernel_checks(door))
    none_of = {"intersect_tiled": 0, "trace_fused": 0}
    retraces = {}

    def route(name, fn):
        def run():
            retraces[name] = count_retraces(fn, name)[1]
        return run

    _, c_door = drive("door_room_progressive",
                      route("door_room_progressive", lambda: phase_door_progressive(door)), {
        **none_of, "gather_rows_t": None, "intersect_pairs_plk": 0,
        "intersect_pairs_mt": DOOR_QUERIES,
        "intersect_blocklist": lambda: retraces["door_room_progressive"]})
    check(c_door["intersect_blocklist"] > 0, "door_room_progressive: no blocklist launch")
    _, c_plk = drive("door_room_plk", route("door_room_plk", lambda: phase_door_plk(door)), {
        **none_of, "intersect_pairs_mt": 0, "intersect_pairs_plk": 2,
        "intersect_blocklist": lambda: retraces["door_room_plk"]})
    routes = {"progressive": c_prog, "frozen_render": c_frozen, "unguided_render": c_render,
              "door_room_progressive": c_door, "door_room_plk": c_plk}
    launches = {k: {r: c[k] for r, c in routes.items()} for k in c_prog}

    entries = phase_timings(scene, tables, grid, checks, launches, card)
    entries += phase_door_timings(door, checks, launches)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
