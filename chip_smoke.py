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
  1. card name and power limit (nvidia-smi), kernel build and ptxas report
     (registers, stack frames, spills of every kernel);
  2. gather_rows_t (R in {36, 512}, C=32, N=524288, indices outside [0, R)
     included; bit-equal) and intersect_tiled against tiled_plain, closest
     and any-hit, mixed and negative tmax (t, prim, u, v, valid and the
     any-hit flags bit-equal on every lane): 524288 Cornell camera rays and
     524288 random rays; veach_mis (3850 triangles) on 65536 camera rays
     and 65535 random rays (not a multiple of the kernel's 32-ray CTA), and
     the random rays against its first 1, 127, 128 and 129 triangles;
  3. the main path: ProgressiveRenderer on cornell_box() at 256x256,
     depth 5, 4 spp x 4 progressions, a 16^3 grid of 8 lobes, guiding on;
     the image must be finite, non-black, within 3% of the JAX reference
     mean below, and the grid must have valid cells;
  4. trace_fused against its plain version at 256x256 x 1 spp, guided
     (with the phase-3 grid) and unguided: L within rtol 1e-3 on >= 99% of
     lanes, image means within 0.5%; then the frozen-cache render (256x256
     x 8 spp per wave = 524288 lanes, 16 waves, guided through
     trace_fused) and the unguided render() at 256x256 x 16 spp (fused
     route); Mrays/s = 2 * sum(n_bounces) / s, and trace_fused's kernel
     time summed over the frozen render's 16 launches;
  3a. phase 3's render with adaptive refinement (4x the rows, split at
     ADAPTIVE_THRESHOLD samples): the grid must grow past 16^3 rows and
     the mean stay within 3% of the reference; n_used after each
     progression and refine_grid's host seconds;
  3b. guiding's equal-spp gain on bounce_lamp_room() at 128x128 (bench.py's
     recipe, the tiled route): relMSE of 8 guided and 8 unguided spp
     against a 96-spp reference; r_g < 0.75 r_u and the guided mean within
     5% of the reference's;
  5. door_room() (244838 triangles): the build (pair and blocklist
     tables), then the kernel checks on 262144 camera rays of a 512x512
     wave and 262144 random rays: the MT and Pluecker pair tiles on their
     sorted pairs, closest and any-hit (t and prim bit-equal on every
     pair); the blocklist kernel on 16384 random
     rays, on all 262144 camera rays, with k=1 (overflow) on 16384 random
     rays, and on the calls of blocklist_calls (the pair route's fallback
     of a first bounce and of a camera wave, a 131072-ray sorted bounce
     wave), closest and any-hit: t, prim, u, v bits and the work counts
     equal to the plain version's; intersect_pairs_full (mt and plk) and
     occluded_pairs_full on 8192 rays of each set against the dense
     oracle (occlusion equal on every ray, prim on every ray but the
     known misses of DOOR_E2E_MISSES);
  6. the door_room main path: ProgressiveRenderer at 512x512, depth 5,
     4 spp x 2 progressions, a 16^3 grid of 8 lobes, guiding on; the image
     must be finite, non-black, within max(3%, 4 standard errors) of the
     JAX reference mean below, and the grid must have valid cells; the
     blocklist's and the MT tiles' kernel times summed over the render's
     launches (CUDA events around each); then one wave of both queries
     through the Pluecker engine;
  7. the interior scene of tools/profile_blocklist_torch.py
     (make_interior(300000): 294924 triangles, 37 two-level superblocks)
     with its 524288 camera rays and 524288 bounce rays, each wave
     through intersect_blocks_sorted (the two-level superblock kernel)
     and through intersect_blocklist_sorted: both against the dense
     oracle on 8192 rays (prim equal on every ray but listed exact ties),
     and the two-level kernel bit-equal to its plain version, work counts
     included, on 16 tiles of each wave given the same mask and order;
  8. door_room's two-level tables (30 superblocks) and the kernel on the
     262144 camera rays of a 512x512 wave, checked as in 7; the BVH
     kernel bit-equal to its plain version (t, prim, u, v and the box-test
     and triangle-test counts) on 262144 camera and 262144 random rays,
     closest and any-hit, and against the dense oracle on 8192 rays of
     each set (occlusion equal on every ray, prim on every ray but exact
     ties);
  9. door_room without pair tables through the Morton-sorted blocklist
     route: ProgressiveRenderer at 512x512, depth 5, 2 spp x 2
     progressions, guided, held to the reference mean as in 6, with the
     blocklist's summed kernel time as in 6; then the
     BVH route: four 131072-ray waves (512x512 x 2 spp, unguided) through
     trace(accel="bvh"), splatted, held to the reference mean with the
     standard error of the two spp;
  9a. guiding's equal-spp gain on door_room() at 512x512 through the BVH
     (bench.py's recipe: 4x the rows, min_rough 0.3, refine_grid at 512
     samples between 4 fitting progressions of 8 waves): relMSE of 4
     guided and 4 unguided spp against a 40-spp reference; the grid past
     16^3 rows, gain > 1.10, both means held to the reference as in 6,
     and the 4-spp windows' Mrays/s;
  10. CUDA-event timings (median of 7, each call enqueued while the card
     spins, so that the events time the card and not the host's enqueue)
     of each kernel, its plain version and, where one exists, the
     one-call PyTorch yardstick; the "kernels"
     line with bounds from this run's inputs (for the blocklist, on its
     three calls of 5, with launch geometry, the tests run and the tests
     needed; for the MT tiles, the tests their kernel runs beside the tests
     needed; for the Pluecker tiles, closest and any-hit, with the L2 warm
     and evicted before each call; for intersect_tiled, closest and
     any-hit on the 65536 camera rays of Cornell and of veach_mis, the
     any-hit bound counting the tests up to each ray's first occluder, and
     its ptxas report; for gather_rows_t, Cornell's 36x32 shading table
     with 65536 random indices and door_room's 244838x32 shading table
     with the hit indices of the BVH's timed camera wave and of its first
     bounce, each bit-equal to the plain version, beside
     torch.index_select, its bytes
     bound counting each distinct row once, and its launches split by
     table size; for the BVH, boxes and triangles tested and its ptxas
     report; the gather and the BVH also timed with the L2 evicted before
     each call, ms_l2_cold), and the Mrays/s of the sorted two-level, sorted blocklist
     and BVH routes.

Each main-path route runs with the launch counts set to 0 just before it
and read just after it, and is held to the kernels it must launch: the
Cornell progressive render to gather_rows_t (none on a table of more than
512 rows, gather_rows_t_large) and intersect_tiled, the
frozen-cache render and the unguided render() to one trace_fused per wave
(and nothing else), the door_room render to one pair-tile (MT) launch per
query (160) and one blocklist launch per query that left a ray unproven
(counted in the same run, ``count_retraces``), the Pluecker wave likewise,
the interior waves to one two-level (or blocklist) launch per wave, the
door_room camera wave to one two-level launch, the sorted-blocklist
render to one blocklist launch per query (80) and the BVH render to one
BVH launch per query (40), each with no launch of the other intersectors;
the three door_room renders to three gathers a bounce, one of them on the
244838-row shading table (240 and 80, 120 and 40, 60 and 20); the
adaptive Cornell render and the bounce-lamp waves to one tiled launch a
query and three small-table gathers a bounce, and the door_room gain
waves to one BVH launch a query and the door_room gathers (1200 and 400).
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

# about a millisecond of the card's clock: cuda_ms enqueues each timed call
# behind such a spin
SLEEP_CYCLES = 2_000_000
# cuda_ms(cold=True) reads this many bytes before each timed call: five
# times the H100's 50 MB L2, so the call finds its inputs in HBM
L2_FLUSH_BYTES = 256 << 20
_L2_FLUSH = []

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

# The routes of a big scene without pair tables: door_room at 512x512,
# depth 5, 2 spp x 2 progressions through the sorted blocklist (8 waves,
# 80 queries) and 2 spp through the BVH (4 waves, 40 queries).
DOOR_SORTED_SPP = 2
DOOR_BVH_SPP = 2
# tools/profile_blocklist_torch.py's interior scene at its defaults
INTERIOR_TRIS = 300000
INTERIOR_RAYS = 524288
CHECK_TILES = 16     # tiles of a wave on which the two-level kernel meets its plain version
ORACLE_RAYS = 8192   # rays of a wave held to the dense oracle
BVH_MT_OPS = 47      # device_math.cuh pg_bvh_mt: one (ray, triangle) test of the BVH walk
BOX_OPS = 23         # device_math.cuh pg_bvh_ray_aabb: one (ray, node box) test
DEVICE = "cuda"      # where the phases below put the scenes they build

# The adaptive Cornell render (phase 3a): splits cells above this many
# samples; a progression of 256x256 x 4 spp leaves hundreds in each
# surface cell of the 16^3 grid.
ADAPTIVE_THRESHOLD = 512.0
ADAPTIVE_CAPACITY = 4
# Guiding's equal-spp gain, bench.py's two recipes on the port (phases 3b
# and 9a); the bars are the JAX package's tests' (tests/test_guiding.py
# test_guiding_beats_unguided_equal_spp and
# test_door_room_guiding_gain_equal_spp).  The JAX package measured 1.94
# and 1.14 (BENCH_r05.json, image quality, not time).
BOUNCE_W = BOUNCE_H = 128
BOUNCE_DEPTH = 4
BOUNCE_WAVES = {"reference": (200, 96), "unguided": (500, 8), "fit": (0, 16), "guided": (500, 8)}
BOUNCE_RATIO_BAR = 0.75   # r_g < 0.75 r_u
BOUNCE_MEAN_TOL = 0.05
DOOR_GAIN_REFERENCE = (0, 40)   # waves 0-39: bench.py's timed windows run on into the reference
DOOR_GAIN_WINDOW = (100, 4)     # the equal-spp windows, unguided and guided
DOOR_GAIN_PROGRESSIONS = 4      # of DOOR_FIT_WAVES each, refined after the first three
DOOR_FIT_WAVES = 8
DOOR_SPLIT_THRESHOLD = 512.0
DOOR_GAIN_BAR = 1.10
NONE_LAUNCHED = {k: 0 for k in ("gather_rows_t", "gather_rows_t_large", "intersect_tiled",
                                "trace_fused", "intersect_pairs_mt", "intersect_pairs_plk",
                                "intersect_blocklist", "intersect_twolevel", "intersect_bvh")}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps=7, warmup=2, cold=False):
    """The median of ``reps`` CUDA-event times of fn(), each call enqueued
    while the card spins SLEEP_CYCLES, so that the events time the card's
    work and not the host's enqueue of it (a short kernel is over before
    its wrapper returns).  With ``cold``, a read of L2_FLUSH_BYTES between
    the spin and the first event evicts the L2, so the call reads its
    inputs from HBM as the bounds assume; a read and not a write, so that
    the call pays for no write-back of the flush's lines."""
    import torch

    if cold and not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda"))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        if cold:
            _L2_FLUSH[0].sum()
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


def gather_call(table, idx):
    """gather_rows_t on one call: bit-equal to its plain version, then the
    kernel, the plain version and torch.index_select(...).T.contiguous()
    timed, and the bound: the indices read, each distinct row read once
    (counted from the call's own indices) and the (C, N) output written."""
    import torch

    from mitsuba_path_guiding_torch.ops.gather import gather_rows_t_cuda, gather_rows_t_plain

    got = gather_rows_t_cuda(table, idx)
    torch.cuda.synchronize()
    check(torch.equal(got, gather_rows_t_plain(table, idx)),
          f"gather_rows_t {tuple(table.shape)} x {idx.numel()}: not bit-equal")
    r, c = table.shape
    n = idx.numel()
    distinct = int(torch.unique(idx.long().clamp(0, r - 1)).numel())
    b_ms, b_by = bound(n * idx.element_size() + distinct * c * 4 + c * n * 4, 0)
    return {"ms": cuda_ms(lambda: gather_rows_t_cuda(table, idx)),
            "ms_l2_cold": cuda_ms(lambda: gather_rows_t_cuda(table, idx), cold=True),
            "plain_ms": cuda_ms(lambda: gather_rows_t_plain(table, idx).contiguous()),
            "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx).T.contiguous()),
            "bound_ms": b_ms, "bound_by": b_by, "distinct_rows": distinct,
            "shape": f"table {r}x{c} f32, {n} {str(idx.dtype).replace('torch.', '')} indices",
            "bit_equal": True}


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
    ptxas = {name: ptxas_report(name) for name in build.KERNEL_SOURCES}
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "ptxas": ptxas})
    return smi


def ptxas_report(name):
    """The lines of a source's ptxas report that name its kernels, their
    registers, stack frames and spills."""
    from mitsuba_path_guiding_torch.ops import build

    return [ln.strip() for ln in build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


def tiled_check(geo, o, d, tmax, n_tri, label):
    """intersect_tiled against tiled_plain over the first n_tri triangles
    of geo, closest hit and any-hit: every output bit equal on every lane,
    or a failure that names the lanes that differ."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_tiled import (
        intersect_tiled,
        pack_triangles,
        tiled_plain,
    )

    pack = pack_triangles(geo.p0[:n_tri], geo.e1[:n_tri], geo.e2[:n_tri])
    got = intersect_tiled(pack, o, d, tmax, n_tri)
    occ = intersect_tiled(pack, o, d, tmax, n_tri, any_hit=True)
    want = tiled_plain(pack, o, d, tmax, n_tri)
    occ_want = tiled_plain(pack, o, d, tmax, n_tri, any_hit=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "prim", "u", "v", "valid", "any-hit"), (*got, occ),
                          (*want, occ_want)):
        differ = _bits(a) != _bits(b)
        check(not bool(differ.any()),
              f"intersect_tiled {label}: {name} differs on {int(differ.sum())} lanes, first "
              f"{torch.nonzero(differ).flatten()[:4].tolist()}")
    return {"rays": o.shape[0], "triangles": n_tri, "bit_equal": True,
            "hit_share": float(got[4].float().mean()), "dead_lanes": int((tmax < 0).sum())}


def phase_kernel_checks(scene, veach):
    import torch

    from mitsuba_path_guiding_torch.ops.gather import gather_rows_t, gather_rows_t_plain

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

    sets = [("cornell_camera", scene, *camera_rays(scene, 8, 0)[:2]),
             ("cornell_random", scene, *random_rays(scene, n, gen, mixed_tmax=False)[:2]),
             ("veach_mis_camera", veach, *camera_rays(veach, 1, 0)[:2]),
             ("veach_mis_random", veach, *random_rays(veach, W * H - 1, gen, mixed_tmax=False)[:2])]
    for label, sc, o, d in sets:
        m = o.shape[0]
        sel = torch.randint(0, 3, (m,), generator=gen, device=dev)
        tmax = torch.where(sel == 0, 3.0e37, torch.where(
            sel == 1, 4.0 * torch.rand((m,), generator=gen, device=dev), -1.0))
        n_tris = (sc.geo.p0.shape[0],) + ((1, 127, 128, 129) if label == "veach_mis_random" else ())
        for n_tri in n_tris:
            res[f"intersect_tiled_{label}_{n_tri}"] = tiled_check(sc.geo, o, d, tmax, n_tri,
                                                                  f"{label} {n_tri}")
    res["intersect_tiled"] = {
        "check": "t, prim, u, v, valid and the any-hit flags bit-equal to tiled_plain on every "
                 "lane", "max_abs_err": 0.0}
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
    rec = {"phase": "frozen_render", "card": card, "waves": FROZEN_WAVES,
           "lanes_per_wave": 8 * n_pix, "seconds": round(dt, 4),
           "mrays_per_s": 2 * int(segs) / dt / 1e6, "mean": mean}
    emit(rec)
    return tables, rec


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


def door_gathers(waves):
    """The gathers of a door_room route of ``waves`` waves: each bounce
    fetches one shading row (the 244838-row table, a large one), one
    material row and one emitter row (small tables)."""
    return {"gather_rows_t": 3 * DEPTH * waves, "gather_rows_t_large": DEPTH * waves}


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


def tiled_any_tests(pack, o, d, tmax, n_tri):
    """The triangle tests an any-hit walk in ascending id needs on these
    rays: up to and including a ray's first occluder, all n_tri for an
    unoccluded ray, none for a dead one (tmax <= EPS_T)."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_tiled import (
        EPS_T,
        INF,
        PLAIN_PAIRS,
        mt_components,
    )

    p0, e1, e2 = (pack[r:r + 3, :n_tri].T for r in (0, 3, 6))
    step = max(1, PLAIN_PAIRS // n_tri)
    total = 0
    for a in range(0, o.shape[0], step):
        tm = tmax[a:a + step]
        t, _, _, hit = mt_components(p0, e1, e2, o[a:a + step], d[a:a + step])
        hit = hit & (t < torch.clamp_max(tm, INF)[None, :])
        first = torch.where(hit.any(dim=0), hit.to(torch.int32).argmax(dim=0) + 1, n_tri)
        total += int(torch.where(tm > EPS_T, first, 0).sum())
    return total


def phase_timings(scene, veach, tables, grid, checks, launches, card):
    import torch

    from mitsuba_path_guiding_torch.ops.fused_path import (
        _pack_guide,
        trace_fused_cuda,
        trace_fused_plain,
    )
    from mitsuba_path_guiding_torch.ops.gather import SMALL_ROWS
    from mitsuba_path_guiding_torch.ops.intersect_tiled import (
        intersect_tiled_cuda,
        pack_triangles,
        tiled_plain,
    )

    dev = scene.geo.p0.device
    n_pix = W * H
    entries = []
    # gather: the main path's shading-row fetch, (36, 32) table x 65536 lanes
    geo = scene.geo
    table = geo.shade_packed
    idx = torch.randint(0, table.shape[0], (n_pix,), device=dev, dtype=torch.int32)
    cornell = gather_call(table, idx)
    r, c = table.shape
    entries.append({
        "name": "gather_rows_t", "route": "cuda",
        "source": "mitsuba_path_guiding_torch/csrc/gather_rows.cu",
        "replaces": "mitsuba_path_guiding_tpu/ops/gather_pallas.py:32",
        "launches": sum(launches["gather_rows_t"].values()),
        "launches_by_route": launches["gather_rows_t"],
        "launches_by_table": {
            f"rows<={SMALL_ROWS}": {k: v - launches["gather_rows_t_large"][k]
                                    for k, v in launches["gather_rows_t"].items()},
            f"rows>{SMALL_ROWS}": launches["gather_rows_t_large"]},
        "max_abs_err": checks["gather_rows_t"]["max_abs_err"],
        **{k: cornell[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": cornell["shape"], "calls": {"cornell": cornell},
        "ptxas": ptxas_report("gather_rows"), "check": "bit-equal on every checked and timed call"})

    # intersect_tiled: a wave of 65536 camera rays, closest hit and any-hit,
    # through Cornell's 36 triangles and veach_mis's 3850.  A closest hit
    # needs every test of a live ray; an any-hit walk in ascending id the
    # tests up to the first occluder (tiled_any_tests).
    tiled_calls = {}
    for label, sc in (("cornell", scene), ("veach_mis", veach)):
        o, d, _ = camera_rays(sc, 1, 2000)
        m = o.shape[0]
        tmax = torch.full((m,), 3.0e37, device=dev)
        pack = pack_triangles(sc.geo.p0, sc.geo.e1, sc.geo.e2)
        nt = sc.geo.p0.shape[0]
        for any_hit in (False, True):
            tests = tiled_any_tests(pack, o, d, tmax, nt) if any_hit else m * nt
            b_ms, b_by = bound(pack.numel() * 4 + m * (28 + (1 if any_hit else 16)),
                               tests * MT_OPS)
            tiled_calls[f"{label}_{'any' if any_hit else 'closest'}"] = {
                "ms": cuda_ms(lambda: intersect_tiled_cuda(pack, o, d, tmax, nt, any_hit)),
                "plain_ms": cuda_ms(lambda: tiled_plain(pack, o, d, tmax, nt, any_hit),
                                    reps=3, warmup=1),
                "bound_ms": b_ms, "bound_by": b_by, "triangle_tests": tests,
                "shape": f"{m} camera rays x {nt} triangles"}
    main_call = tiled_calls["cornell_closest"]
    entries.append({
        "name": "intersect_tiled", "route": "cuda",
        "source": "mitsuba_path_guiding_torch/csrc/intersect_tiled.cu",
        "replaces": "mitsuba_path_guiding_tpu/ops/intersect_pallas.py:30",
        "launches": sum(launches["intersect_tiled"].values()),
        "launches_by_route": launches["intersect_tiled"],
        "max_abs_err": checks["intersect_tiled"]["max_abs_err"],
        **{k: main_call[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "shape": main_call["shape"] + ", closest hit",
        "calls": tiled_calls, "ptxas": ptxas_report("intersect_tiled"),
        "check": checks["intersect_tiled"]["check"]})

    n_tri = geo.p0.shape[0]
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
# the guiding layer: adaptive refinement and guiding's equal-spp gain
# ---------------------------------------------------------------------------

def phase_progressive_adaptive(scene):
    """Phase 3's render with adaptive refinement: n_used after each
    progression, the host seconds of each refine_grid (the queued work
    finished first), and the mean held to the reference."""
    import torch

    from mitsuba_path_guiding_torch.integrators import progressive
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    cfg = progressive.ProgressiveConfig(
        render=RenderConfig(width=W, height=H, spp=0, max_depth=DEPTH), samples_per_progression=4,
        n_progressions=4, guiding=True, grid_res=16, n_lobes=8, adaptive_refine=True,
        refine_threshold=ADAPTIVE_THRESHOLD, capacity_factor=ADAPTIVE_CAPACITY)
    renderer = progressive.ProgressiveRenderer(scene, cfg)
    n_used, refine_s = [], []
    real = progressive.refine_grid

    def timed_refine(grid, threshold):
        torch.cuda.synchronize()
        t0 = time.time()
        out = real(grid, threshold)
        refine_s.append(time.time() - t0)
        n_used.append(out.n_used)
        return out

    progressive.refine_grid = timed_refine
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        img = renderer.render()
        torch.cuda.synchronize()
        dt = time.time() - t0
    finally:
        progressive.refine_grid = real
    mean = float(img.mean())
    rel = abs(mean - CORNELL_REFERENCE_MEAN) / CORNELL_REFERENCE_MEAN
    check(bool(torch.isfinite(img).all()), "adaptive progressive image not finite")
    check(renderer.grid.n_used > 16**3, f"adaptive progressive: no cell split ({n_used})")
    check(int(renderer.grid.valid.sum()) > 0, "adaptive progressive grid has no valid cells")
    check(rel < MEAN_TOL, f"adaptive progressive mean {mean} vs reference {CORNELL_REFERENCE_MEAN}")
    segs = renderer.stats.get("rays traced") / 2
    emit({"phase": "progressive_adaptive", "seconds": round(dt, 3), "mean": mean,
          "reference_mean": CORNELL_REFERENCE_MEAN, "rel_err": rel,
          "refine_threshold": ADAPTIVE_THRESHOLD, "capacity": renderer.grid.child_base.shape[0],
          "n_used_per_progression": n_used, "refine_grid_host_s": refine_s,
          "max_level": int(renderer.grid.level.max()), "mrays_per_s": 2 * segs / dt / 1e6})


def equal_spp_waves(scene, width, height, depth, guide, levels, accel="auto", seed=0):
    """bench.py's wave loop on the port: wave w renders one sample per pixel
    with the keys of sample index w (bench.py's seed 0) and splats it; with ``fit``
    each wave makes one fitting step of the grid.  waves(grid, w0, n_w,
    guided, fit) returns (the image (n_pix, 3) on the host, the grid, the
    path segments, each wave's image mean)."""
    import torch

    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.film.film import splat_box_aligned
    from mitsuba_path_guiding_torch.guiding.fit import accumulate_stats, update_grid
    from mitsuba_path_guiding_torch.integrators.path import trace
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present
    from mitsuba_path_guiding_torch.models.sensor import generate_rays

    dev = scene.geo.p0.device
    n_pix = width * height
    pix = torch.arange(n_pix, device=dev)
    key = rng.base_key(seed, device=dev)
    kw = dict(max_depth=depth, em_kinds=kinds_present(scene.emitters),
              mat_types=types_present(scene.mats), accel=accel)

    def waves(grid, w0, n_w, guided=False, fit=False):
        rgbw = torch.zeros((n_pix, 4), device=dev)
        segs = torch.zeros((), dtype=torch.int64, device=dev)
        means = []
        for w in range(w0, w0 + n_w):
            rk = rng.ray_keys(key, pix, torch.full_like(pix, w))
            o, d, _ = generate_rays(scene.sensor, width, height, pix,
                                    rng.event_uniform(rk, rng.TAG_CAMERA, 2))
            L, aux, rec = trace(scene, o, d, rk, guide=guide if guided else None,
                                guide_state=grid if guided else None, record_paths=fit, **kw)
            splat_box_aligned(rgbw, L, n_pix)
            segs += aux.n_bounces.sum()
            means.append(L.mean())
            if fit:
                grid = update_grid(grid, *accumulate_stats(grid, rec, levels=levels))
        img = (rgbw[:, 0:3] / torch.clamp_min(rgbw[:, 3:4], 1e-9)).cpu().numpy()
        return img, grid, int(segs), [float(m) for m in means]

    return waves


def relmse(img, ref, trim=False):
    """bench.py's relMSE against the reference image: eps = (0.1 mean)^2;
    with ``trim`` the top 0.1% of pixels left out (the bounce-lamp
    recipe)."""
    import numpy as np

    e = ((img - ref) ** 2 / (ref**2 + (0.1 * float(ref.mean())) ** 2)).ravel()
    return float(np.sort(e)[:int(e.size * 0.999)].mean()) if trim else float(e.mean())


def phase_gain_bounce_lamp(card):
    """bench.py's bounce-lamp recipe: bounce_lamp_room() at 128x128, depth
    4, a 16^3 grid of 8 lobes walked at its active levels (0), the tiled
    route; a 96-wave unguided reference, 8 unguided waves, 16 guided
    fitting waves (one fitting step a wave), then 8 guided waves."""
    from mitsuba_path_guiding_torch.guiding.grid import active_levels, make_grid
    from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import bounce_lamp_room

    t0 = time.time()
    scene = build_scene(bounce_lamp_room(), device=DEVICE)
    grid0 = make_grid(scene.aabb_min, scene.aabb_max, res=16, n_lobes=8)
    levels = active_levels(grid0)
    guide = make_guide_fn(0.5, types_present(scene.mats), levels=levels)
    waves = equal_spp_waves(scene, BOUNCE_W, BOUNCE_H, BOUNCE_DEPTH, guide, levels)
    ref = waves(grid0, *BOUNCE_WAVES["reference"])[0]
    un = waves(grid0, *BOUNCE_WAVES["unguided"])[0]
    grid = waves(grid0, *BOUNCE_WAVES["fit"], guided=True, fit=True)[1]
    g8 = waves(grid, *BOUNCE_WAVES["guided"], guided=True)[0]
    dt = time.time() - t0
    r_u, r_g = relmse(un, ref, trim=True), relmse(g8, ref, trim=True)
    rel_mean = abs(float(g8.mean()) - float(ref.mean())) / float(ref.mean())
    check(r_g < BOUNCE_RATIO_BAR * r_u, f"bounce-lamp: guided relMSE {r_g} vs unguided {r_u}")
    check(rel_mean < BOUNCE_MEAN_TOL, f"bounce-lamp: guided mean {g8.mean()} vs {ref.mean()}")
    emit({"phase": "guiding_gain_bounce_lamp", "card": card, "seconds": round(dt, 3),
          "levels": levels, "relmse_unguided": r_u, "relmse_guided": r_g, "gain": r_u / r_g,
          "bar": f"r_g < {BOUNCE_RATIO_BAR} r_u", "guided_mean": float(g8.mean()),
          "reference_mean": float(ref.mean()), "guided_mean_rel_err": rel_mean,
          "jax_package_gain_bench_r05": 1.94})


def door_gain_run(scene, width=DOOR_W, height=DOOR_H, seed=0, reference=DOOR_GAIN_REFERENCE,
                  window=DOOR_GAIN_WINDOW, progressions=DOOR_GAIN_PROGRESSIONS,
                  threshold=DOOR_SPLIT_THRESHOLD):
    """bench.py's door_room recipe through the BVH: depth 5, a 16^3 grid of
    8 lobes with room for 4x the rows, walked MAX_REFINE_LEVELS deep,
    min_rough 0.3; an unguided reference over the ``reference`` waves, the
    unguided ``window``, ``progressions`` fitting progressions of 8 guided
    waves (one fitting step a wave, refine_grid(grid, threshold) after all
    but the last), the guided ``window``.  A wave is the whole image; the
    keys are those of ``seed``."""
    import torch

    from mitsuba_path_guiding_torch.guiding.fit import refine_grid
    from mitsuba_path_guiding_torch.guiding.grid import MAX_REFINE_LEVELS, make_grid
    from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
    from mitsuba_path_guiding_torch.models.bsdf import types_present

    levels = MAX_REFINE_LEVELS
    guide = make_guide_fn(0.5, types_present(scene.mats), levels=levels, min_rough=0.3)
    waves = equal_spp_waves(scene, width, height, DEPTH, guide, levels, accel="bvh", seed=seed)
    grid0 = make_grid(scene.aabb_min, scene.aabb_max, res=16, n_lobes=8, capacity=4 * 16**3)
    ref = waves(grid0, *reference)[0]

    def timed_window(grid, guided):
        torch.cuda.synchronize()
        t0 = time.time()
        img, _, segs, means = waves(grid, *window, guided=guided)
        dt = time.time() - t0
        return img, {"seconds": dt, "mrays_per_s": 2 * segs / dt / 1e6, "spp_means": means}

    un, un_t = timed_window(grid0, False)
    grid, n_used, t_fit = grid0, [], time.time()
    for prog in range(progressions):
        grid = waves(grid, prog * DOOR_FIT_WAVES, DOOR_FIT_WAVES, guided=True, fit=True)[1]
        if prog < progressions - 1:
            grid = refine_grid(grid, threshold)
        n_used.append(grid.n_used)
    torch.cuda.synchronize()
    t_fit = time.time() - t_fit
    g4, g_t = timed_window(grid, True)
    r_u, r_g = relmse(un, ref), relmse(g4, ref)
    return {"ref": ref, "un": un, "un_t": un_t, "g4": g4, "g_t": g_t, "grid": grid,
            "n_used": n_used, "fit_seconds": t_fit, "r_u": r_u, "r_g": r_g,
            "gain": r_u / max(r_g, 1e-9)}


def fit_sums_repeat(rows, calls=3):
    """The fit's per-cell sums (guiding/fit.py cell_sums) called ``calls``
    times on one (rows, 45) payload whose cell ids crowd the low cells, as
    a wave's path vertices crowd a few cells: bit-equal each time?"""
    import torch

    from mitsuba_path_guiding_torch.guiding.fit import cell_sums

    g = torch.Generator(device="cuda").manual_seed(3)
    n_cells = 4 * 16**3
    cid = (torch.rand((rows,), generator=g, device="cuda") ** 4 * n_cells).long()
    payload = torch.randn((rows, 45), generator=g, device="cuda")
    first = cell_sums(n_cells, cid, payload)
    same = all(torch.equal(first, cell_sums(n_cells, cid, payload)) for _ in range(calls - 1))
    return {"rows": rows, "calls": calls, "bit_equal": same}


def phase_gain_door_room(scene, card):
    """door_gain_run at bench.py's size, 512x512 (262144 lanes a wave): a
    40-spp unguided reference, 4 unguided spp, 4 fitting progressions
    refined at 512 samples, 4 guided spp."""
    import numpy as np

    t_all = time.time()
    run = door_gain_run(scene)
    grid, n_used, r_u, r_g, gain = run["grid"], run["n_used"], run["r_u"], run["r_g"], run["gain"]
    un, un_t, g4, g_t = run["un"], run["un_t"], run["g4"], run["g_t"]
    t_fit = run["fit_seconds"]
    sums_repeat = fit_sums_repeat(DEPTH * DOOR_W * DOOR_H)
    out = {"phase": "guiding_gain_door_room", "card": card, "seconds": round(time.time() - t_all, 3),
           "relmse_unguided": r_u, "relmse_guided": r_g, "gain": gain, "bar": DOOR_GAIN_BAR,
           "n_used_per_progression": n_used, "fit_seconds": t_fit,
           "unguided_window": un_t, "guided_window": g_t,
           "jax_package_bench_r05": {"relmse_unguided": 11.99, "relmse_guided": 10.51,
                                     "gain": 1.14, "route": "pair"}}
    for name, img, tm in (("unguided", un, un_t), ("guided", g4, g_t)):
        mean = float(img.mean())
        se = statistics.stdev(tm["spp_means"]) / len(tm["spp_means"]) ** 0.5
        tol = max(MEAN_TOL, 4.0 * (DOOR_REFERENCE_SE**2 + se**2) ** 0.5 / DOOR_REFERENCE_MEAN)
        rel = abs(mean - DOOR_REFERENCE_MEAN) / DOOR_REFERENCE_MEAN
        out[f"{name}_mean"] = {"mean": mean, "rel_err": rel, "rel_tol": tol, "se_card": se}
        check(bool(np.isfinite(img).all()), f"door_room {name} image not finite")
        check(rel < tol, f"door_room gain, {name} mean {mean} vs reference {DOOR_REFERENCE_MEAN}")
    out["fit_sums_repeat"] = sums_repeat
    emit(out)
    check(sums_repeat["bit_equal"], "door_room gain: the fit's cell sums differ between calls")
    check(grid.n_used > 16**3, f"door_room gain: no cell split ({n_used})")
    check(gain > DOOR_GAIN_BAR, f"door_room gain {gain} (r_u {r_u}, r_g {r_g}) <= {DOOR_GAIN_BAR}")
    return out


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


def first_bounce(scene, o, d, tmax, seed):
    """Diffuse bounce rays from the camera hits of (o, d) through the pair
    route: (origin, direction, tmax), tmax -1 where the camera ray missed."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pairs_full
    from mitsuba_path_guiding_torch.integrators.path import PAIR_CAP

    geo = scene.geo
    hit = intersect_pairs_full(scene.pairs, scene.blocks, o, d, tmax, cap_factor=PAIR_CAP)
    ng = geo.shade_packed[hit.prim.clamp_min(0).long(), 0:3]
    ng = ng * torch.sign((ng * -d).sum(-1, keepdim=True))
    gen = torch.Generator(device=o.device).manual_seed(seed)
    w = torch.nn.functional.normalize(torch.randn(o.shape, generator=gen, device=o.device), dim=-1)
    w = torch.where((w * ng).sum(-1, keepdim=True) < 0, -w, w)
    o2 = o + torch.where(hit.valid, hit.t, 1.0)[:, None] * d + ng * 1e-4
    return o2, w, torch.where(hit.valid, 3.0e37, -1.0)


def blocklist_calls(scene, sorted_camera=False):
    """The blocklist kernel's inputs on calls of the main paths, from the
    second 131072-ray camera wave of door_room at 512x512 (seed 9) and its
    first bounce (seed 4): the pair route's fallback of the bounce and of
    the wave (their unproven rays), and the bounce wave sorted as the
    sorted route sorts it (512 tiles); with ``sorted_camera`` the camera
    wave sorted too.  Returns {label: ((bl, o_p, d_p, t_p, cand, cnt),
    info)}."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import _retrace
    from mitsuba_path_guiding_torch.integrators.path import PAIR_CAP
    from mitsuba_path_guiding_torch.ops.intersect_blocklist import (
        _pad_rays,
        _ray_sort_keys,
        cand_width,
        candidate_superblocks,
    )
    from mitsuba_path_guiding_torch.ops.intersect_pairs import intersect_pairs_raw

    bl = scene.blocks
    o, d, _ = camera_rays(scene, 1, 9, w=DOOR_W, h=DOOR_H)
    o, d = o[DOOR_WAVE:2 * DOOR_WAVE], d[DOOR_WAVE:2 * DOOR_WAVE]
    tmax = torch.full((DOOR_WAVE,), 3.0e37, device=o.device)
    bounce = first_bounce(scene, o, d, tmax, 4)

    def call(oo, dd, tt, **info):
        o_p, d_p, t_p, npad = _pad_rays(oo, dd, tt)
        k = cand_width(npad, bl.sb_lo.shape[0])
        cand, cnt = candidate_superblocks(bl.sb_lo, bl.sb_hi, o_p, d_p, t_p, k)
        return (bl, o_p, d_p, t_p, cand, cnt), {"rays": npad, "k": k,
                                                "overflow_tiles": int((cnt > k).sum()), **info}

    calls = {}
    for label, (oo, dd, tt) in (("bounce_fallback", bounce), ("camera_fallback", (o, d, tmax))):
        idx = _retrace(intersect_pairs_raw(scene.pairs, oo, dd, tt, cap_factor=PAIR_CAP)[-1])
        calls[label] = call(oo[idx], dd[idx], tt[idx], unproven=int(idx.numel()))
    waves = [("sorted_bounce_wave", bounce)]
    if sorted_camera:
        waves.append(("sorted_camera_wave", (o, d, tmax)))
    for label, (oo, dd, tt) in waves:
        perm = torch.argsort(_ray_sort_keys(bl, oo, dd), stable=True)
        calls[label] = call(oo[perm], dd[perm], tt[perm])
    return calls


def kernel_time(fn, module, attr):
    """Run ``fn`` with every call of ``module.attr`` (a kernel's wrapper)
    bracketed by CUDA events.  Returns (fn's result, {"launches": n,
    "kernel_ms_sum": the summed event times})."""
    import torch

    real = getattr(module, attr)
    events = []

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(*args, **kw)
        b.record()
        events.append((a, b))
        return out

    setattr(module, attr, timed)
    try:
        out = fn()
    finally:
        setattr(module, attr, real)
    torch.cuda.synchronize()
    return out, {"launches": len(events),
                 "kernel_ms_sum": sum(a.elapsed_time(b) for a, b in events)}


def blocklist_kernel_time(fn):
    """``kernel_time`` of the blocklist kernel's launches in ``fn``."""
    from mitsuba_path_guiding_torch.ops import intersect_blocklist as ib

    return kernel_time(fn, ib, "blocklist_cuda")


def mt_kernel_time(fn):
    """``kernel_time`` of the MT pair-tile kernel's launches in ``fn``."""
    from mitsuba_path_guiding_torch.ops import intersect_pairs as ip

    return kernel_time(fn, ip, "mt_tiles")


def mt_tile_work(pt, pdata, tile_block):
    """The MT tile kernel's work on one call, from the tile data: the
    tests the data needs (per live tile, the pairs that can hit, tmax >
    EPS_T, times the real triangles of its block) and the tests the kernel
    runs (per live tile, its live pairs rounded up to whole 32-pair slots
    times the triangle slots up to the block's last real one)."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_pairs import EPS_T, LEAF, TILE

    live = tile_block >= 0
    can_hit = (pdata[6] > EPS_T).reshape(-1, TILE).sum(dim=1)
    real = pt.tri_rows[tile_block.clamp_min(0).long(), 9, :] >= 0
    slots = torch.arange(1, LEAF + 1, device=real.device)
    looped = torch.where(real, slots, 0).max(dim=1).values
    lanes = (can_hit + 31) // 32 * 32
    return {"pairs_that_can_hit": int(torch.where(live, can_hit, 0).sum()),
            "triangle_tests": int(torch.where(live, can_hit * real.sum(dim=1), 0).sum()),
            "tests_run": int(torch.where(live, lanes * looped, 0).sum())}


def phase_door_kernel_checks(scene, bl_calls):
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pairs_full, occluded_pairs_full
    from mitsuba_path_guiding_torch.integrators.path import PAIR_CAP
    from mitsuba_path_guiding_torch.ops.intersect_blocklist import (
        _pad_rays,
        blocklist_cuda,
        blocklist_plain,
        cand_width,
        candidate_superblocks,
        launch_shape,
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
                differ = (_bits(got) != _bits(want)).any(dim=0)
                check(not bool(differ.any()),
                      f"{engine} {label} any_hit={any_hit}: t or prim bits differ on "
                      f"{int(differ.sum())} of {differ.numel()} pairs")
                res[engine][f"{label}_{'any' if any_hit else 'closest'}"] = {
                    "pairs": pdata.shape[1], "live_tiles": int((tile_block >= 0).sum()),
                    "bit_equal": True, "hits": int((want[0] < INF).sum())}

    # blocklist: the fallback-sized call on random rays, a full wave of
    # camera rays, a k=1 (overflow) call, and the calls of blocklist_calls;
    # t, prim, u, v bits and the work counts equal to the plain version's
    calls = {}
    for label, (o, d, tmax), m, k in (("fallback_random", sets["random"], n // 16, 128),
                                      ("full_camera", sets["camera"], n, 128),
                                      ("overflow_random", sets["random"], n // 16, 1)):
        o_p, d_p, t_p, npad = _pad_rays(o[:m], d[:m], tmax[:m])
        kw = cand_width(npad, bl.sb_lo.shape[0], k)
        cand, cnt = candidate_superblocks(bl.sb_lo, bl.sb_hi, o_p, d_p, t_p, kw)
        calls[label] = ((bl, o_p, d_p, t_p, cand, cnt),
                        {"rays": npad, "k": kw, "overflow_tiles": int((cnt > kw).sum())})
    calls.update(bl_calls)
    for label, (args, info) in calls.items():
        for any_hit in (False, True):
            got, gw = blocklist_cuda(*args, any_hit)
            want, ww, run = blocklist_plain(*args, any_hit, tests_run=True)
            torch.cuda.synchronize()
            same_out = torch.equal(_bits(got), _bits(want))
            same_work = torch.equal(gw, ww)
            check(same_out and same_work,
                  f"blocklist {label} any_hit={any_hit}: kernel and plain differ on "
                  f"{int((_bits(got) != _bits(want)).any(dim=0).sum())} rays, "
                  f"work equal {same_work}")
            walked, visits, needed = (int(x) for x in gw.sum(dim=0))
            res["blocklist"][f"{label}_{'any' if any_hit else 'closest'}"] = {
                **info, "bit_equal": True, "superblocks_walked": walked, "visits": visits,
                "tests_needed": needed, "tests_run": int(run.sum()),
                "hit_share": float((got[1] >= 0).float().mean()),
                "geometry": launch_shape(info["rays"], any_hit)}

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
    return {k: {"max_abs_err": v} for k, v in worst.items()}, res["blocklist"]


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


def phase_door_progressive(scene, spp=DOOR_SPP, name="door_room_progressive"):
    import torch

    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_torch.integrators.render import PIXEL_BATCH, RenderConfig

    cfg = ProgressiveConfig(render=RenderConfig(width=DOOR_W, height=DOOR_H, spp=0,
                                                max_depth=DEPTH),
                            samples_per_progression=spp, n_progressions=DOOR_PROGRESSIONS,
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
    rec = {"phase": name, "seconds": round(dt, 3), "mean": mean,
           "reference_mean": DOOR_REFERENCE_MEAN, "rel_err": rel, "rel_tol": tol,
           "se_card": se_card, "progression_means": prog_means, "valid_cells": n_valid,
           "spp": renderer.sample_counter, "mrays_per_s": 2 * segs / dt / 1e6}
    emit(rec)
    return rec


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


def phase_door_timings(scene, checks, launches, bl_calls, bl_rows, bl_render, mt_render):
    """CUDA-event medians of the three pair-pipeline kernels at the main
    path's shapes: the second camera wave (pixels 131072-262143 of 512x512)
    gives the tile kernels its sorted pairs; the blocklist runs the calls
    of ``blocklist_calls`` (the fallback of that wave's first bounce and of
    the wave itself, and the sorted bounce wave).  Each bound counts the
    triangle tests this run's data needs: for the tiles, per live tile the
    pairs that can still hit (t range above EPS_T) times the real triangles
    of its block; for the blocklist, the kernel's own count of them (its
    work row 2).  ``bl_render``: the blocklist's summed kernel time over
    the door_room renders' launches, ``mt_render`` the MT tiles' over the
    pair render's.  The MT entry also counts the tests its kernel runs
    (``mt_tile_work``) and their operations over the FP32 rate
    (``tests_run_floor_ms``), which splits its gap to the bound into tests
    run and time per test.  The Pluecker entry also times the any-hit call
    and both calls with the L2 evicted first (``calls``, ``ms_l2_cold``)."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_blocklist import (
        RAY_TILE,
        SB_BLOCKS,
        blocklist_cuda,
        blocklist_plain,
    )
    from mitsuba_path_guiding_torch.ops.intersect_pairs import (
        TILE,
        mt_tiles,
        mt_tiles_plain,
        plk_tiles,
        plk_tiles_plain,
    )

    pt = scene.pairs
    o, d, _ = camera_rays(scene, 1, 9, w=DOOR_W, h=DOOR_H)
    o, d = o[DOOR_WAVE:2 * DOOR_WAVE], d[DOOR_WAVE:2 * DOOR_WAVE]
    tmax = torch.full((DOOR_WAVE,), 3.0e37, device=o.device)
    pdata, tile_block = _pair_set(scene, o, d, tmax)
    live = int((tile_block >= 0).sum())
    blocks_used = int(torch.unique(tile_block[tile_block >= 0]).numel())
    n_pairs = pdata.shape[1]
    # dead and dummy pairs carry tmax 0, padding triangles id -1
    work = mt_tile_work(pt, pdata, tile_block)
    tests, hit_pairs = work["triangle_tests"], work["pairs_that_can_hit"]
    io_bytes = n_pairs * (7 + 2) * 4 + tile_block.numel() * 4
    no_library = ("none: no single PyTorch call computes a per-pair best hit over a "
                  "gathered triangle block")
    entries = []
    bit_equal = "t and prim bit-equal to the plain version's on every pair, closest and any-hit"
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
            "check": bit_equal})
    mt = entries[0]
    mt["work"]["tests_run"] = work["tests_run"]
    mt["tests_run_floor_ms"] = work["tests_run"] * MT_OPS / FP32_OPS_PER_S * 1e3
    mt["render_kernel_time"] = mt_render
    # the Pluecker tiles closest and any-hit, warm and with the L2 evicted
    # before each call (tri_cols is 78 MB, above the 50 MB L2)
    plk = entries[1]
    plk["calls"] = {}
    for any_hit in (False, True):
        ops = tests * (PLK_ANY_OPS if any_hit else PLK_CLOSEST_OPS) + hit_pairs * PLK_M_OPS
        b_ms, b_by = bound(io_bytes + blocks_used * 26 * TILE * 4, ops)

        def call():
            return plk_tiles(pt.tri_cols, pt.tri_rows, tile_block, pdata, any_hit)
        plk["calls"][f"camera_{'any' if any_hit else 'closest'}"] = {
            "ms": cuda_ms(call), "ms_l2_cold": cuda_ms(call, cold=True), "bound_ms": b_ms,
            "bound_by": b_by, "fp32_ops": ops}
    plk["ms_l2_cold"] = plk["calls"]["camera_closest"]["ms_l2_cold"]
    plk["ptxas"] = ptxas_report("intersect_pairs")

    # the blocklist on three calls of the main paths: the two fallbacks
    # and a sorted bounce wave
    calls = {}
    for label, (args, info) in bl_calls.items():
        row = bl_rows[f"{label}_closest"]
        walked, needed, run = row["superblocks_walked"], row["tests_needed"], row["tests_run"]
        ops = walked * RAY_TILE * SB_BLOCKS * GATE_OPS + needed * MT_OPS
        cand = args[4]
        # rays in (o, d, tmax), t/prim/u/v out, the candidate table; the
        # block tables are not counted (a lower bound)
        b_ms, b_by = bound(info["rays"] * (7 + 4) * 4 + cand.numel() * 4 + cand.shape[0] * 4,
                           ops)
        calls[label] = {
            "ms": cuda_ms(lambda: blocklist_cuda(*args)),
            "plain_ms": cuda_ms(lambda: blocklist_plain(*args), reps=1, warmup=0),
            "bound_ms": b_ms, "bound_by": b_by,
            # the operations of every test the visits run, over the same rate
            "tests_run_floor_ms": (walked * RAY_TILE * SB_BLOCKS * GATE_OPS + run * MT_OPS)
                                  / FP32_OPS_PER_S * 1e3,
            **{k: v for k, v in row.items() if k not in ("bit_equal",)},
            "fp32_ops": ops}
    main_call = calls["bounce_fallback"]
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
        "calls": calls, "render_kernel_time": bl_render,
        "check": "t, prim, u, v bits and work counts equal to the plain version's, closest "
                 "and any-hit, on every checked call"})
    return entries


# ---------------------------------------------------------------------------
# big scenes without pair tables: the two-level kernel, the sorted
# blocklist and the BVH
# ---------------------------------------------------------------------------

def _interior_tools():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import profile_blocklist_torch

    return profile_blocklist_torch


def _bits(x):
    import torch

    return x.contiguous().view(torch.int32) if x.dtype == torch.float32 else x


def oracle_check(geo, o, d, tmax, t, prim, label, occ=None):
    """Hits (t, prim) of ORACLE_RAYS rays spread over a wave against the
    dense oracle: prim equal on every ray but exact ties (the same t from
    another triangle); with ``occ``, occlusion equal on every ray."""
    import torch

    sel = torch.linspace(0, o.shape[0] - 1, ORACLE_RAYS, device=o.device).round().long()
    t_ref, prim_ref = brute_chunked(geo, o[sel], d[sel], tmax[sel])
    t_s, p_s = t[sel], prim[sel]
    diff = p_s != prim_ref
    tie = diff & (t_s == t_ref)
    misses = int((diff & ~tie).sum())
    bad = torch.nonzero(diff & ~tie).flatten()[:4]
    check(misses == 0, f"{label}: {misses} prim misses against the oracle; t {t_s[bad].tolist()} "
                       f"vs {t_ref[bad].tolist()}, prim {p_s[bad].tolist()} vs "
                       f"{prim_ref[bad].tolist()}")
    row = {"rays": ORACLE_RAYS, "prim_misses": misses,
           "exact_ties": [[int(sel[i]), int(p_s[i]), int(prim_ref[i])]
                          for i in torch.nonzero(tie).flatten().tolist()]}
    if occ is not None:
        occ_ref = brute_chunked(geo, o[sel], d[sel], tmax[sel], any_hit=True)
        o_miss = int((occ[sel] != occ_ref).sum())
        check(o_miss == 0, f"{label}: {o_miss} occlusion misses against the oracle")
        row["occlusion_misses"] = o_miss
    return row


def twolevel_inputs(bt, o, d, tmax):
    """The kernel's inputs (ray, tmax, mask, order) as
    intersect_blocks_sorted gives them."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_twolevel import (
        _pad_rays,
        _ray_sort_keys,
        superblock_mask,
    )

    perm = torch.argsort(_ray_sort_keys(bt, o, d), stable=True)
    o, d, tmax = o[perm], d[perm], tmax[perm]
    return (*_pad_rays(o, d, tmax), *superblock_mask(bt, o, d, tmax))


def twolevel_check(bt, inputs, label):
    """Kernel 7 against its plain version on CHECK_TILES tiles spread over
    the wave, given the same mask and order: t, prim, u, v and the work
    counts bit-equal.  Returns (a summary, the kernel's work over the
    whole wave)."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_twolevel import (
        RAY_TILE,
        twolevel_cuda,
        twolevel_plain,
    )

    ray, tmax_p, mask, order = inputs
    out, work = twolevel_cuda(bt, ray, tmax_p, mask, order)
    nt = mask.shape[0]
    tiles = torch.linspace(0, nt - 1, CHECK_TILES, device=ray.device).round().long().unique()
    cols = (tiles[:, None] * RAY_TILE + torch.arange(RAY_TILE, device=ray.device)).flatten()
    t0 = time.time()
    want, wwork = twolevel_plain(bt, ray[:, cols], tmax_p[cols], mask[tiles], order)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    got = out[:, cols]
    same_out = torch.equal(_bits(got), _bits(want))
    same_work = torch.equal(work[tiles], wwork)
    check(same_out and same_work,
          f"twolevel {label}: kernel and plain differ on "
          f"{int((_bits(got) != _bits(want)).any(dim=0).sum())} rays, work equal {same_work}")
    w = work.sum(dim=0).tolist()
    return {"tiles": nt, "checked_tiles": int(tiles.numel()), "bit_equal": True,
            "plain_seconds_on_checked_tiles": round(plain_s, 3),
            "superblocks_walked": w[0], "blocks_opened": w[1], "tests_run": w[2],
            "tests_needed": w[3], "hit_share": float((out[1] >= 0).float().mean())}, work


def twolevel_bound(inputs, work):
    """Operations: 23 per (ray, block) gate of every superblock a tile
    walks, 46 per needed triangle test.  Bytes: rays in, results out, the
    mask and order, the boxes and rows of the superblocks some tile walks
    (an upper estimate of the rows read).  The work also holds the
    tests-run floor: those gates and every test run, 46 operations each."""
    from mitsuba_path_guiding_torch.ops.intersect_twolevel import RAY_TILE, SB_BLOCKS, SB_TRIS

    ray, _, mask, order = inputs
    walked, opened, run, needed = (int(x) for x in work.sum(dim=0))
    ops = walked * RAY_TILE * SB_BLOCKS * GATE_OPS + needed * MT_OPS
    live_sb = int(mask.any(dim=0).sum())
    n_bytes = (ray.shape[1] * (7 + 4) * 4 + mask.numel() * 4 + order.numel() * 4
               + live_sb * (SB_BLOCKS * 6 * 4 + 10 * SB_TRIS * 4))
    b_ms, b_by = bound(n_bytes, ops)
    # the same gates and every test the tile-wide OR runs
    floor_ms = (walked * RAY_TILE * SB_BLOCKS * GATE_OPS + run * MT_OPS) / FP32_OPS_PER_S * 1e3
    return b_ms, b_by, {"superblocks_walked": walked, "blocks_opened": opened,
                        "tests_run": run, "tests_needed": needed, "fp32_ops": ops,
                        "bytes": n_bytes, "tests_run_floor_ms": floor_ms}


def phase_interior():
    """The microbenchmark's interior scene: the build, the camera and
    bounce waves through both sorted routes (each a main-path route of its
    own), both against the oracle, kernel 7 against its plain version."""
    import types

    import torch

    from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
    from mitsuba_path_guiding_torch.accel.bvh import build_bvh, to_device
    from mitsuba_path_guiding_torch.ops.intersect_blocklist import intersect_blocklist_sorted
    from mitsuba_path_guiding_torch.ops.intersect_twolevel import (
        build_blocks,
        intersect_blocks_sorted,
    )

    tools = _interior_tools()
    t0 = time.time()
    p0, e1, e2 = tools.make_interior(INTERIOR_TRIS)
    bt = build_blocks(p0, e1, e2, device=DEVICE)
    bl = to_device(build_blocklist(p0, e1, e2, build_bvh(p0, e1, e2)), DEVICE)
    geo = types.SimpleNamespace(**{k: torch.from_numpy(v).to(DEVICE)
                                   for k, v in (("p0", p0), ("e1", e1), ("e2", e2))})
    n_sb = bt.tri_pack.shape[0]
    check(p0.shape[0] == 294924 and n_sb == 37,
          f"interior: {p0.shape[0]} triangles, {n_sb} superblocks")
    build_s = time.time() - t0
    tmax = torch.full((INTERIOR_RAYS,), 3.0e38, device=DEVICE)
    cam, bounce = tools.interior_waves(p0, e1, e2, INTERIOR_RAYS,
                                       lambda o, d, t: intersect_blocklist_sorted(bl, o, d, t),
                                       torch.device(DEVICE))
    waves = {"camera": cam, "bounce": bounce}
    hits = {}

    def run(route, fn):
        def go():
            for wave, (o, d) in waves.items():
                hits[(route, wave)] = fn(o, d, tmax)
        return go

    _, c_tl = drive("interior_twolevel",
                    run("twolevel", lambda o, d, t: intersect_blocks_sorted(bt, o, d, t)),
                    {**NONE_LAUNCHED, "intersect_twolevel": len(waves)})
    _, c_bl = drive("interior_blocklist_sorted",
                    run("blocklist", lambda o, d, t: intersect_blocklist_sorted(bl, o, d, t)),
                    {**NONE_LAUNCHED, "intersect_blocklist": len(waves)})
    res, inputs = {}, {}
    for wave, (o, d) in waves.items():
        for route in ("twolevel", "blocklist"):
            t, prim = hits[(route, wave)][0:2]
            res[f"{route}_{wave}_oracle"] = oracle_check(geo, o, d, tmax, t, prim,
                                                         f"interior {route} {wave}")
        tl_in = twolevel_inputs(bt, o, d, tmax)
        res[f"twolevel_{wave}_kernel"], work = twolevel_check(bt, tl_in, f"interior {wave}")
        inputs[wave] = (tl_in, work)
    emit({"phase": "interior", "seconds": round(time.time() - t0, 3),
          "build_seconds": round(build_s, 3), "triangles": int(p0.shape[0]),
          "twolevel_superblocks": n_sb, "blocklist_superblocks": int(bl.sb_lo.shape[0]), **res})
    return {"bt": bt, "bl": bl, "waves": waves, "tmax": tmax, "inputs": inputs,
            "launches": {"interior_twolevel": c_tl, "interior_blocklist_sorted": c_bl}}


def phase_door_twolevel_bvh(scene):
    """door_room: kernel 7 on the camera rays of a 512x512 wave (a
    main-path route of its own); the BVH kernel against its plain version
    and the oracle."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_cuda, bvh_plain
    from mitsuba_path_guiding_torch.ops.intersect_twolevel import (
        build_blocks,
        intersect_blocks_sorted,
    )

    t0 = time.time()
    geo = scene.geo
    bt = build_blocks(*(x.cpu().numpy() for x in (geo.p0, geo.e1, geo.e2)), device=DEVICE)
    check(bt.tri_pack.shape[0] == 30, f"door_room: {bt.tri_pack.shape[0]} two-level superblocks")
    n = DOOR_W * DOOR_H
    o_cam, d_cam, _ = camera_rays(scene, 1, 0, w=DOOR_W, h=DOOR_H)
    t_cam = torch.full((n,), 3.0e37, device=o_cam.device)
    gen = torch.Generator(device=o_cam.device).manual_seed(5)
    sets = {"camera": (o_cam, d_cam, t_cam), "random": random_rays(scene, n, gen)}
    hit, c_tl = drive("door_room_twolevel",
                      lambda: intersect_blocks_sorted(bt, o_cam, d_cam, t_cam),
                      {**NONE_LAUNCHED, "intersect_twolevel": 1})
    res = {"twolevel_camera_oracle": oracle_check(geo, o_cam, d_cam, t_cam, hit[0], hit[1],
                                                  "door_room twolevel camera")}
    tl_in = twolevel_inputs(bt, o_cam, d_cam, t_cam)
    res["twolevel_camera_kernel"], work = twolevel_check(bt, tl_in, "door_room camera")
    for label, (o, d, tmax) in sets.items():
        for any_hit in (False, True):
            got = bvh_cuda(scene.bvh, o, d, tmax, any_hit)
            t1 = time.time()
            want = bvh_plain(scene.bvh, o, d, tmax, any_hit)
            torch.cuda.synchronize()
            plain_s = time.time() - t1
            same = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))
            check(same, f"bvh {label} any_hit={any_hit}: kernel and plain differ on "
                        f"{int((got[1] != want[1]).sum())} prims, "
                        f"{int((_bits(got[0]) != _bits(want[0])).sum())} t")
            row = {"bit_equal": True, "plain_seconds": round(plain_s, 3),
                   "hit_share": float((got[1] >= 0).float().mean()),
                   "box_tests": int(got[4][0].sum()), "triangles_tested": int(got[4][1].sum())}
            if not any_hit:
                t_h = torch.where(got[1] >= 0, got[0], 3.0e38)
                row["oracle"] = oracle_check(geo, o, d, tmax, t_h, got[1], f"bvh {label}",
                                             occ=got[1] >= 0)
            res[f"bvh_{label}_{'any' if any_hit else 'closest'}"] = row
    emit({"phase": "door_room_twolevel_bvh", "seconds": round(time.time() - t0, 3), **res})
    return {"bt": bt, "inputs": (tl_in, work), "launches": c_tl}


def phase_door_bvh_render(scene, card):
    """The BVH route: 512x512 x DOOR_BVH_SPP unguided, waves of DOOR_WAVE
    pixels through trace(accel="bvh"), each spp splatted into a film of
    its own for the render's standard error."""
    import torch

    from mitsuba_path_guiding_torch.film.film import splat
    from mitsuba_path_guiding_torch.integrators.path import trace
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, wave_keys_and_jitter
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present
    from mitsuba_path_guiding_torch.models.sensor import generate_rays

    cfg = RenderConfig(width=DOOR_W, height=DOOR_H, spp=DOOR_BVH_SPP, max_depth=DEPTH)
    dev = scene.geo.p0.device
    n_pix = DOOR_W * DOOR_H
    films = torch.zeros((DOOR_BVH_SPP, n_pix, 4), device=dev)
    kw = dict(max_depth=DEPTH, rr_depth=cfg.rr_depth, accel="bvh",
              em_kinds=kinds_present(scene.emitters), mat_types=types_present(scene.mats))
    segs = torch.zeros((), dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    for s in range(DOOR_BVH_SPP):
        for start in range(0, n_pix, DOOR_WAVE):
            pix = torch.arange(start, start + DOOR_WAVE, device=dev)
            _, rkeys, u_cam, u_pos = wave_keys_and_jitter(cfg, pix, torch.full_like(pix, s))
            o, d, xy = generate_rays(scene.sensor, DOOR_W, DOOR_H, pix, u_pos, u_cam[..., 2:4],
                                     kind=scene.sensor.kind)
            L, aux, _ = trace(scene, o, d, rkeys, **kw)
            splat(films[s], xy, L, DOOR_W, DOOR_H)
            segs += aux.n_bounces.sum()
    torch.cuda.synchronize()
    dt = time.time() - t0
    means = [float((f[:, 0:3] / f[:, 3:4].clamp_min(1e-8)).mean()) for f in films]
    total = films.sum(dim=0)
    img = total[:, 0:3] / total[:, 3:4].clamp_min(1e-8)
    mean = float(img.mean())
    check(bool(torch.isfinite(img).all()), "door_room BVH image not finite")
    check(mean > 0.0, "door_room BVH image is black")
    se_card = abs(means[0] - means[1]) / 2.0
    tol = max(MEAN_TOL, 4.0 * (DOOR_REFERENCE_SE**2 + se_card**2) ** 0.5 / DOOR_REFERENCE_MEAN)
    rel = abs(mean - DOOR_REFERENCE_MEAN) / DOOR_REFERENCE_MEAN
    check(rel < tol, f"door_room BVH mean {mean} vs reference {DOOR_REFERENCE_MEAN} (tol {tol})")
    rec = {"phase": "door_room_bvh_render", "card": card, "seconds": round(dt, 3), "mean": mean,
           "reference_mean": DOOR_REFERENCE_MEAN, "rel_err": rel, "rel_tol": tol,
           "se_card": se_card, "spp_means": means, "waves": DOOR_BVH_SPP * n_pix // DOOR_WAVE,
           "mrays_per_s": 2 * int(segs) / dt / 1e6}
    emit(rec)
    return rec


def phase_new_timings(interior, door_tl, door, launches, card):
    """Kernel 7 on the interior waves and the door_room camera wave, the
    BVH kernel on a door_room camera wave and a bounce of it, the
    shading-row gather of each of those two waves' hits (the 244838-row
    table), and the sorted routes' Mrays/s on the interior waves.
    Returns (the kernels' entries, the gather's calls)."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_blocklist import intersect_blocklist_sorted
    from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_cuda, bvh_plain
    from mitsuba_path_guiding_torch.ops.intersect_twolevel import (
        intersect_blocks_sorted,
        twolevel_cuda,
        twolevel_plain,
    )

    calls = {}
    for name, bt, (inputs, work) in (
            ("interior_camera", interior["bt"], interior["inputs"]["camera"]),
            ("interior_bounce", interior["bt"], interior["inputs"]["bounce"]),
            ("door_room_camera", door_tl["bt"], door_tl["inputs"])):
        b_ms, b_by, w = twolevel_bound(inputs, work)
        calls[name] = {"ms": cuda_ms(lambda: twolevel_cuda(bt, *inputs)),
                       "ms_l2_cold": cuda_ms(lambda: twolevel_cuda(bt, *inputs), cold=True),
                       "bound_ms": b_ms, "bound_by": b_by, "rays": inputs[0].shape[1],
                       "work": w}
    main_call = calls["interior_camera"]
    bt, (inputs, _) = interior["bt"], interior["inputs"]["camera"]
    main_call["plain_ms"] = cuda_ms(lambda: twolevel_plain(bt, *inputs), reps=1, warmup=0)
    routes = {}
    tmax = interior["tmax"]
    for wave, (o, d) in interior["waves"].items():
        for route, fn in (
                ("twolevel_sorted", lambda: intersect_blocks_sorted(interior["bt"], o, d, tmax)),
                ("blocklist_sorted", lambda: intersect_blocklist_sorted(interior["bl"], o, d,
                                                                        tmax))):
            ms = cuda_ms(fn, reps=3, warmup=1)
            routes[f"{route}_{wave}"] = {"ms": ms, "mrays_per_s": INTERIOR_RAYS / ms / 1e3}
    entries = [{
        "name": "intersect_twolevel", "route": "cuda",
        "source": "mitsuba_path_guiding_torch/csrc/intersect_twolevel.cu",
        "replaces": "mitsuba_path_guiding_tpu/ops/intersect_twolevel.py:161",
        "launches": sum(launches["intersect_twolevel"].values()),
        "launches_by_route": launches["intersect_twolevel"],
        "max_abs_err": 0.0, "ms": main_call["ms"], "plain_ms": main_call["plain_ms"],
        "bound_ms": main_call["bound_ms"], "bound_by": main_call["bound_by"],
        "library_ms": None, "library": "none: no one call walks superblocks near to far "
                                       "behind a per-block gate",
        "shape": f"interior camera wave: {INTERIOR_RAYS} sorted rays, "
                 f"{interior['bt'].tri_pack.shape[0]} superblocks",
        "work": main_call["work"], "calls": calls, "routes": routes,
        "ptxas": ptxas_report("intersect_twolevel"),
        "check": "t, prim, u, v and work counts bit-equal on 16 tiles of each wave"}]

    # the BVH on one wave of its route: 131072 camera rays, and a first
    # bounce of them (diffuse directions from the camera hits)
    geo = door.geo
    o, d, _ = camera_rays(door, 1, 11, w=DOOR_W, h=DOOR_H)
    o, d = o[DOOR_WAVE:2 * DOOR_WAVE], d[DOOR_WAVE:2 * DOOR_WAVE]
    tmax = torch.full((DOOR_WAVE,), 3.0e37, device=o.device)
    bvh_calls, gather_calls = {}, {}
    for label, (oo, dd, tt) in (("camera", (o, d, tmax)),
                                ("bounce", first_bounce(door, o, d, tmax, 6))):
        args = (door.bvh, oo, dd, tt)
        hit = bvh_cuda(*args)
        counts = hit[4]
        # the shading-row gather of this wave's hits, as trace() makes it
        gather_calls[f"door_room_{label}"] = gather_call(geo.shade_packed, hit[1].clamp_min(0))
        boxes, tests = int(counts[0].sum()), int(counts[1].sum())
        ops = boxes * BOX_OPS + tests * BVH_MT_OPS
        # rays in, t/prim/u/v and the counts out; the node and triangle
        # reads are left out (a lower bound)
        b_ms, b_by = bound(DOOR_WAVE * (7 + 4 + 2) * 4, ops)
        bvh_calls[label] = {
            "ms": cuda_ms(lambda: bvh_cuda(*args)),
            "ms_l2_cold": cuda_ms(lambda: bvh_cuda(*args), cold=True),
            "plain_ms": cuda_ms(lambda: bvh_plain(*args), reps=1, warmup=0),
            "bound_ms": b_ms, "bound_by": b_by,
            "work": {"box_tests": boxes, "triangle_tests": tests, "fp32_ops": ops}}
    main_call = bvh_calls["camera"]
    entries.append({
        "name": "intersect_bvh", "route": "cuda",
        "source": "mitsuba_path_guiding_torch/csrc/intersect_bvh.cu",
        "replaces": "mitsuba_path_guiding_tpu/accel/traverse.py:137 (a vmapped while_loop, "
                    "not a Pallas kernel)",
        "launches": sum(launches["intersect_bvh"].values()),
        "launches_by_route": launches["intersect_bvh"],
        "max_abs_err": 0.0, "ms": main_call["ms"], "plain_ms": main_call["plain_ms"],
        "bound_ms": main_call["bound_ms"], "bound_by": main_call["bound_by"],
        "library_ms": None, "library": "none: no one call walks a BVH",
        "shape": f"{DOOR_WAVE} door_room camera rays, closest hit",
        "work": main_call["work"], "calls": bvh_calls, "ptxas": ptxas_report("intersect_bvh"),
        "mrays_per_s": DOOR_WAVE / main_call["ms"] / 1e3,
        "check": "t, prim, u, v and box and triangle counts bit-equal, closest and any-hit"})
    emit({"phase": "new_timings", "card": card, "twolevel_routes": routes})
    return entries, gather_calls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mitsuba_path_guiding_torch.ops import fused_path
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box, veach_mis

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = phase_build()
    scene = build_scene(cornell_box(), device="cuda")
    veach = build_scene(veach_mis(), device="cuda")
    checks = phase_kernel_checks(scene, veach)

    no_pairs = {"intersect_pairs_mt": 0, "intersect_pairs_plk": 0, "intersect_blocklist": 0,
                "intersect_twolevel": 0, "intersect_bvh": 0}
    only_fused = {"gather_rows_t": 0, "gather_rows_t_large": 0, "intersect_tiled": 0,
                  **no_pairs}
    grid, c_prog = drive("progressive", lambda: phase_progressive(scene),
                         {"gather_rows_t": None, "gather_rows_t_large": 0,
                          "intersect_tiled": None, "trace_fused": 0, **no_pairs})
    # the fused kernel against its plain version first, so that the renders
    # below time a kernel that is loaded and checked
    checks["trace_fused"] = phase_fused_check(scene, fused_path.build_fused_tables(scene), grid)
    ((tables, _), fused_t), c_frozen = drive(
        "frozen_render",
        lambda: kernel_time(lambda: phase_frozen(scene, grid, card), fused_path, "trace_fused_cuda"),
        {**only_fused, "trace_fused": FROZEN_WAVES})
    emit({"phase": "trace_fused_kernel_time", "route": "frozen_render", **fused_t})
    _, c_render = drive("unguided_render", lambda: phase_unguided_render(scene, card),
                        {**only_fused, "trace_fused": RENDER_SPP})
    # 16 waves (4 spp x 4 progressions of 256x256 pixels), each bounce one
    # tiled closest-hit and one tiled shadow query and three small-table
    # gathers
    _, c_adaptive = drive("progressive_adaptive", lambda: phase_progressive_adaptive(scene),
                          {**NONE_LAUNCHED, "intersect_tiled": 2 * DEPTH * 16,
                           "gather_rows_t": 3 * DEPTH * 16})
    bounce_waves = sum(n for _, n in BOUNCE_WAVES.values())
    _, c_bounce = drive("guiding_gain_bounce_lamp", lambda: phase_gain_bounce_lamp(card),
                        {**NONE_LAUNCHED, "intersect_tiled": 2 * BOUNCE_DEPTH * bounce_waves,
                         "gather_rows_t": 3 * BOUNCE_DEPTH * bounce_waves})

    door = phase_door_build()
    bl_calls = blocklist_calls(door)
    door_checks, bl_rows = phase_door_kernel_checks(door, bl_calls)
    checks.update(door_checks)
    none_of = {"intersect_tiled": 0, "trace_fused": 0, "intersect_twolevel": 0,
               "intersect_bvh": 0}
    waves_per_spp = DOOR_W * DOOR_H // DOOR_WAVE
    retraces = {}
    bl_render = {}  # the blocklist's summed kernel time over a route's launches
    mt_render = {}  # the MT tiles' likewise

    def timed(name, fn):
        def run():
            (_, bl_render[name]), mt = mt_kernel_time(lambda: blocklist_kernel_time(fn))
            emit({"phase": "blocklist_kernel_time", "route": name, **bl_render[name]})
            if mt["launches"]:
                mt_render[name] = mt
                emit({"phase": "mt_kernel_time", "route": name, **mt})
        return run

    def route(name, fn):
        def run():
            retraces[name] = count_retraces(timed(name, fn), name)[1]
        return run

    _, c_door = drive("door_room_progressive",
                      route("door_room_progressive", lambda: phase_door_progressive(door)), {
        **none_of, **door_gathers(DOOR_WAVES), "intersect_pairs_plk": 0,
        "intersect_pairs_mt": DOOR_QUERIES,
        "intersect_blocklist": lambda: retraces["door_room_progressive"]})
    check(c_door["intersect_blocklist"] > 0, "door_room_progressive: no blocklist launch")
    _, c_plk = drive("door_room_plk", route("door_room_plk", lambda: phase_door_plk(door)), {
        **none_of, "gather_rows_t_large": 0, "intersect_pairs_mt": 0, "intersect_pairs_plk": 2,
        "intersect_blocklist": lambda: retraces["door_room_plk"]})

    interior = phase_interior()
    door_tl = phase_door_twolevel_bvh(door)
    _, c_sorted = drive("door_room_sorted_blocklist",
                        timed("door_room_sorted_blocklist",
                              lambda: phase_door_progressive(door._replace(pairs=None),
                                                             DOOR_SORTED_SPP,
                                                             "door_room_sorted_blocklist")),
                        {**NONE_LAUNCHED,
                         **door_gathers(DOOR_PROGRESSIONS * DOOR_SORTED_SPP * waves_per_spp),
                         "intersect_blocklist": 2 * DEPTH * DOOR_PROGRESSIONS * DOOR_SORTED_SPP
                         * waves_per_spp})
    _, c_bvh = drive("door_room_bvh", lambda: phase_door_bvh_render(door, card),
                     {**NONE_LAUNCHED, **door_gathers(DOOR_BVH_SPP * waves_per_spp),
                      "intersect_bvh": 2 * DEPTH * DOOR_BVH_SPP * waves_per_spp})
    door_gain_waves = (DOOR_GAIN_REFERENCE[1] + 2 * DOOR_GAIN_WINDOW[1]
                       + DOOR_FIT_WAVES * DOOR_GAIN_PROGRESSIONS)
    _, c_door_gain = drive("guiding_gain_door_room", lambda: phase_gain_door_room(door, card),
                           {**NONE_LAUNCHED, **door_gathers(door_gain_waves),
                            "intersect_bvh": 2 * DEPTH * door_gain_waves})
    routes = {"progressive": c_prog, "frozen_render": c_frozen, "unguided_render": c_render,
              "progressive_adaptive": c_adaptive, "guiding_gain_bounce_lamp": c_bounce,
              "guiding_gain_door_room": c_door_gain,
              "door_room_progressive": c_door, "door_room_plk": c_plk, **interior["launches"],
              "door_room_twolevel": door_tl["launches"], "door_room_sorted_blocklist": c_sorted,
              "door_room_bvh": c_bvh}
    launches = {k: {r: c[k] for r, c in routes.items()} for k in c_prog}

    entries = phase_timings(scene, veach, tables, grid, checks, launches, card)
    entries += phase_door_timings(door, checks, launches, bl_calls, bl_rows, bl_render,
                                  mt_render)
    new_entries, gather_calls = phase_new_timings(interior, door_tl, door, launches, card)
    entries[0]["calls"].update(gather_calls)
    entries += new_entries
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
