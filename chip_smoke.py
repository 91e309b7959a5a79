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
  11. "shading" (slice 5): see phase_shading_kernel_checks and run_shading.
  12. "vocabulary" (slice 6): gather_rows_t on the rough-coated Cornell
     box's (M, 16) coat transmittance table (the kernel's general path),
     bit-equal and timed, and intersect_tiled bit-equal on the sunsky
     plane's camera wave; then at 256x256, depth 5: the coated,
     rough-coated (alpha 0.1) and HK Cornell boxes, guided progressive 4
     spp x 4; the sky, sun and sunsky planes and the Cornell box through
     the orthographic, spherical, thin-lens and telecentric sensors,
     unguided render() in 4 groups of 4 spp; each mean within max(3%, 4
     standard errors) of the JAX package's CPU mean (SHADING_REFERENCE,
     tools/shading_reference_means.py); the radiance, irradiance and
     fluence meters in a constant environment of radiance 2 within 5% of
     2, 2 pi and 8 pi; Cornell through the stratified, halton,
     hammersley, sobol and ldsampler samplers and sobol with 2 Sobol'
     bounces (16 spp), and the six reconstruction filters (8 spp), each
     mean held to the Cornell reference, each sampler's relMSE against a
     512-spp independent image printed beside the independent sampler's
     at equal spp.  Every render prints its Mrays/s and its launches.
  13. "volumes" (slice 7): intersect_tiled and the BVH bit-equal to their
     plain versions, closest and any-hit, on a volbox wave's first medium
     events (origins in mid-air, HG-sampled directions) and their NEE
     shadow rays, gather_rows_t bit-equal on those hits' shading rows;
     then the volbox at the CLI's defaults (256x256, guided progressive 4
     spp x 4, depth 5) with guided distance sampling on and off, the grid
     box likewise, the volbox through the BVH, each mean held to the JAX
     package's CPU mean (VOLUME_REFERENCE, tools/volume_reference_means.py),
     the volbox renders' relMSE against a 64-spp unguided card image
     (printed, no bar); bench.py's volumetric recipe (256x256, depth 8,
     8 waves of 4 spp) with its Mrays/s; the Rayleigh, Kajiya-Kay,
     microflake and mixture phases at 128x128 x 16 spp; render_scanned
     (render itself) repeating bit for bit at 128x128; the firefly clamp (every sample at or
     below it, the image at or below the unclamped one); the host syncs a
     wave of the Cornell, volbox and grid-box waves (torch's sync debug
     mode; printed, no bar).  A volume bounce is two queries and three
     gathers.
  14. "splat": the film's splat (core.math.scatter_add_rows, an order
     fixed by the data) against the same splat through index_add_ on
     Cornell's fused and wavefront waves and through the Gaussian filter,
     each beside the wave's own time; the ordered splat repeats bit for
     bit.
  15. "textures" (slice 8): gather_rows_t bit-equal on the (T, 9)
     vertex-colour table of a curvature-coloured sphere (the kernel's
     general path) and timed on a camera wave's hits; intersect_tiled
     bit-equal on the checkerboard Cornell box's camera wave; then at
     256x256, depth 5, guided 4 spp x 4: the Cornell box with a
     checkerboard floor, a bitmap under scale, a bitmap read from a .pfm
     written at run time, normal- and bump-mapped walls, a wireframe box
     and the curvature-coloured sphere, an irawan back wall, and a sphere
     under an envmap read from a .pfm; through render() in 4 groups of 4
     spp: the checkerboard box unguided (no trace_fused), the JAX
     package's test_mipmap.py floor with cone filtering and its
     test_cloth.py irawan plane (the weave's inner std above 0.01); each
     mean within max(3%, 4 standard errors) of the JAX package's CPU mean
     (TEXTURE_REFERENCE, tools/texture_reference_means.py); then the
     CLI's cornell at 256x256, 16 spp with --denoise --aovs: the neural
     denoiser ran, its card output equals the CPU's on the same buffers
     (rtol 1e-4, atol 1e-6), its relMSE against a 256-spp image is below
     the noisy image's, and its time.
  16. "integrators" (slice 9): intersect_tiled and the BVH bit-equal to
     their plain versions, closest and any-hit, on the first 65536
     emitter rays of render_ptracer's first wave on the Cornell box and
     on their first hits' sensor-connection shadow rays, gather_rows_t
     bit-equal on those hits' shading rows, and intersect_tiled on one
     VPL chunk's fan (32 VPLs x 65536 camera hits); then, each in 4 groups
     of 4 spp (seeds 0-3) at the CLI's defaults (256x256, depth 5): the
     Cornell box through the path tracer, direct, ao, ptracer, bdpt, vpl
     (256 VPL paths) and bdpt through the BVH; the JAX package's
     point-light Cornell box at depth 2 (path, bdpt); veach_mis at
     512x512 (path, bdpt); each mean within max(3%, 4 standard
     errors) of the JAX package's CPU mean (INTEGRATOR_REFERENCE,
     tools/integrator_reference_means.py); bdpt/path within 3%,
     ptracer/path within 8%, vpl/path in (0.85, 1.05) (the JAX package's
     tests' bars), veach's bdpt/path printed without a bar; direct equal
     to render() at depth 1; ptracer and bdpt repeating bit for bit; the
     CLI's cornell -I bdpt; the host syncs a wave of ptracer and bdpt by
     source line; seconds and query-lane Mrays/s of each render.
  17. "chains" (slice 10): intersect_tiled and the BVH bit-equal to their
     plain versions, closest and any-hit, on an SPPM photon wave's
     first-bounce rays on the Cornell box (131072 photons), one MLT
     perturbation's reconnection shadow rays on the caustic box (4096
     chains) and a volume photon wave's rays in the medium box (65536
     photons), gather_rows_t bit-equal on the MLT bootstrap's hits; then
     on the Cornell box at the CLI's defaults (256x256, 16 spp, depth 5)
     pssmlt, mlt, erpt, sppm and photonmapper through render_once (sppm
     through the BVH too), each twice and bit-equal, each image's mean
     over the path tracer's inside the JAX tests' bars, the BVH's within
     1% of the tiled route's; the CLI's cornell -I sppm; the JAX package's
     MLT, PSSMLT, ERPT, SPPM and photon-mapper tests' runs (CHAIN_RUNS on
     chain_descs' scenes, 4 seeds each, 2 for ERPT) against JAX CPU means
     (CHAIN_REFERENCE, tools/chain_reference_means.py) and against the
     path tracer with the tests' bars (CHAIN_BARS), path space beating
     PSS on the caustic box, mlt through the BVH within 1% of the tiled
     route; the volume photon map's beam estimate within 15% of
     trace_vol, repeating bit for bit; the host syncs a step; seconds and
     query-lane Mrays/s of each render.
  18. "scene_files" (slice 11): the Cornell box written as Mitsuba XML
     (scene_xml: every to_world a <matrix> of repr floats) compiles equal
     to the built-in; the CLI's main() on it at its defaults (256x256,
     16 spp, guided 4 x 4) and with -I path gives images bit-equal to
     main(["cornell", ...]); two -s 8 -c runs equal the -s 16 image bit
     for bit; --preview 0 serves a finished 256x256 PNG; door_room
     written as XML with its spheres as PLY files of doubles compiles
     equal to the built-in (pair tables and blocklist included) and its
     guided 512x512 render (2 spp x 2, the pair route) equals the
     built-in's bit for bit; util kdbench times intersect_tiled on 65536
     rays of the XML Cornell and of the largest sphere PLY (its card
     time between CUDA events); the seconds of every step, the XML and
     the built-in renders timed again in alternating order after the
     counted runs (alternating_seconds: medians, spread and their ratio).
  19. "sharded" (slice 12): parallel.mesh.render_sharded in processes of
     its own (spawn_ranks: the spawn start method, a file:// rendezvous
     under build/chip_smoke/sharded/), at world size 1 on NCCL and at
     world size 2 on gloo with both ranks on cuda:0 (NCCL refuses two
     ranks on one card; gloo stages the merges through host memory): the
     unguided Cornell box at 128x128, depth 5, 4 calls of 16 spp, bit-equal
     on every rank of both world sizes and its mean within max(3%, 4
     standard errors) of CORNELL_REFERENCE_MEAN; the guided Cornell box at
     256x256 x 16 spp (fit every 4 waves) twice at world size 2, bit-equal
     across runs and ranks, its grids equal, its mean within 8% of the
     unguided render's (tests/test_sharding.py's bar); the collectives (one
     film merge a call, one stats merge every 4 waves, none a wave);
     __graft_entry__.dryrun_multichip's steps at world size 2: door_room(
     120000) guided at 128x128, depth 5, one step through the pair route
     (film weight = pixels, segments > pixels, a fitted grid), the 1080p
     film in two guided bands of 2 rows, and the heterogeneous box's
     volumetric step with guided distance sampling; each rank's seconds,
     launches and collective bytes a progression.
  20. "irrcache_subsurface" (slice 12): intersect_tiled and the BVH
     bit-equal to their plain versions, closest and any-hit, on the
     irradiance cache's gather rays and NEE shadow rays (Cornell, 512
     records x 64 rays) and on the slab's irradiance samples' NEE shadow
     rays, gather_rows_t bit-equal on the samples' shading rows; then the
     JAX tests' configurations (IRR_RUNS on subsurface_descs' scenes):
     render_irrcache on Cornell by the tiled route and the BVH, twice
     each, bit-equal, over render() (192 spp) in (0.8, 1.2); the
     translucent slab (mean > 1e-4, sigma_a 5 below half of it) and the
     single-scattering sphere (mean > 1e-4, over 1.5x the sigma_s 0.1
     sphere's, g 0.8 changing the mean by more than 2%); each mean within
     max(3%, 4 standard errors) of the JAX package's CPU mean at the same
     seed (IRR_REFERENCE, tools/irrcache_subsurface_reference_means.py);
     seconds and launches of each render.
  21. "gradients_manifold_spectral_motion" (slice 13): numpy's version;
     gather_rows_t's backward through GatherRowsT bit-equal to autograd's
     gradient of the plain version on the card (Cornell's shading table at
     a 256x256 camera wave's hits, repeated rows and misses), timed beside
     its forward, its plain version and index_add_; the tiled kernel's
     closest hit with a gradient (winner_with_grad) bit-equal to the
     kernel's; intersect_tiled bit-equal to its plain version on the
     manifold walk's re-projection rays (the wavy surface, 4608 triangles)
     and on render_motion's first-hit rays; tests/test_grad.py's three
     gradients (GRAD_RUNS) through trace on the card, each within its
     test's bar and within 1e-3 of JAX's CPU gradient on the same rays
     (SLICE13_REFERENCE, tools/slice13_reference_means.py); render() of the
     Cornell box with mats.packed requiring grad through the wavefront (no
     trace_fused), its gradient within 1e-3 of the CPU's, and the fused
     wrapper refusing such a table; the manifold walk on the wavy surface
     (> 95% converged, Snell's law, a repeat bit-equal),
     generalized_geometry within a 5% median of finite differences,
     manifold NEE within 8% of brute force with 80000 rays a point;
     eval_basis on the card within 1e-6 of the CPU and sample_sh's chi^2;
     SPECTRAL_RUNS (the hero scene by the scan and by bins, the dispersive
     sphere both ways, the spectral Cornell box through trace_fused) and
     MOTION_RUNS (the moving sphere and the deformable plane, blurred and
     still), each twice at its seed (bit-equal), each mean within max(3%,
     4 standard errors) of the JAX CPU mean, with the JAX tests' bars (the scan over the bins within 6%,
     the dispersive sphere's mean above 1e-3, the blur's edge gradient
     below 0.8 of the still sphere's, the blurred plane's tint covering
     more pixels); render_motion at 64x64 with the JAX test's checks and
     its summary against JAX's; seconds and launches of each render.

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
waves to one BVH launch a query and the door_room gathers (1200 and 400);
the vocabulary's wavefront renders to two tiled launches a bounce and
three gathers (five with a coat: its nested rows and its coat-table
row), its independent-sampler Cornell renders to one trace_fused a wave;
the textures' renders to two tiled launches a bounce and three gathers
(four with vertex colours) and no trace_fused; the integrators' renders
to the launches integrator_launches counts (a light-path bounce two
queries and two gathers, a BDPT camera bounce a third gather and a wave
(D - 1) D / 2 interior shadow queries, a VPL chunk one query and two
gathers; the Cornell path tracer and direct one trace_fused a wave); the
chains' renders to the launches chain_launches counts (a PSSMLT or ERPT
trace two queries and three gathers a bounce; an MLT path a query and
two gathers a bounce, a perturbation V + 1 queries and 4V + 3 gathers;
an SPPM pass 2D queries and 4D + 2 gathers; the photon mapper's photon
wave D queries and 2D + 1 gathers, a camera sample D + 2 and 2D + 3; a
volume photon wave D queries and one gather); the scene files' renders
to the launches of the same route on the built-in scene (the Cornell
guided render 160 tiled and 240 gathers, -I path 16 trace_fused, the
door_room render 80 MT tiles, 120 gathers of which 40 on the large table,
and a blocklist launch per query that left a ray unproven) and kdbench
to 6 tiled launches; each rank of the sharded renders, on its shard, to
the launches of the same route unsharded (a Cornell bounce two tiled
queries and three gathers, no trace_fused; a door_room bounce one MT
pair-tile launch a query, at most one blocklist launch a query and three
gathers, one on the large table; a volume bounce two tiled queries and
three gathers); the irradiance cache and subsurface renders to
irr_launches (a camera pass of depth D D queries and 2D gathers, an NEE
sample a query and a gather); phase 21's traces and wavefront renders to
two tiled queries and three gathers a bounce (wave_launches; the shading
row's on a large table above 512 triangles), the spectral Cornell box to
one trace_fused a bin a sample, a manifold walk to 13 tiled launches and
render_motion to one.
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
CORNELL_REFERENCE_SE = 0.00021
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


# ---------------------------------------------------------------------------
# the shading breadth: analytic BSDF families, environment and delta
# emitters, transparent shadows
# ---------------------------------------------------------------------------

SHADE_W = SHADE_H = 256
FURNACE_SPP = {True: 48, False: 8}     # NEE on, NEE off (tests/test_render.py's bars)
FURNACE_TOL = {True: 0.02, False: 1e-4}
FURNACE_BORDER_ROWS = 32               # the sphere's top edge is at row 48
FURNACE_CENTRE = slice(112, 144)       # well inside the sphere's disk
MASK_SPP = 8
MASK_DEPTH = 9                          # pass-throughs spend depth
MASK_TOL = 0.05
VEACH_W = VEACH_H = 512
# Image means of the JAX package on the CPU, unguided, 128x128 x 64 spp (8
# groups of 8 spp, seeds 1000-1007), depth 5, with their standard errors
# over the groups (tools/shading_reference_means.py)
SHADING_REFERENCE = {
    "cornell_glass": (0.10983477998524904, 0.00023354688426345248),
    "cornell_mirror": (0.11891961470246315, 0.0004703238832224376),
    "veach_mis": (0.2850442975759506, 0.0036488629469124904),
    # the vocabulary phase's scenes (vocabulary_descs), one run of 70.5 s
    "cornell_coating": (0.10910035856068134, 0.00021600490766381095),
    "cornell_roughcoating": (0.10901905968785286, 0.00020939744716564425),
    "cornell_hk": (0.10655821580439806, 0.0002109382210435026),
    "sky": (0.6427139416337013, 0.00014881391990161118),
    "sun": (0.00899671867955476, 4.1175605574201175e-06),
    "sunsky": (0.6516549214720726, 0.0001441705643453525),
    "cornell_orthographic": (0.11648211162537336, 6.615952264381384e-05),
    "cornell_spherical": (1.0676129758358002, 0.0002166853104705525),
    "cornell_thinlens": (0.11456377431750298, 0.0003035078921063422),
    "cornell_telecentric": (0.11749121733009815, 0.0001013830901008974),
}
# sample_direct on the card against the CPU: at least this share of lanes
# bit-equal in every field, and every lane that is not explained by
# area_sample_witness (an op of the area branch that, given the same
# inputs, does not give the same bits on the card as on the CPU).  A
# grazing lane's pdf, dist^2 / (|cos| area), amplifies such a last-bit
# difference, hence its wider rtol.
SAMPLE_DIRECT_MIN_EQUAL = 0.99
SAMPLE_DIRECT_RTOL = {"direction": 1e-5, "distance": 1e-5, "radiance": 1e-5, "pdf": 1e-4}
MASK_BSDF = {"type": "mask", "opacity": [0.0] * 3, "bsdf": {"type": "diffuse"}}
BLEND_BSDF = {"type": "blendbsdf", "weight": 0.4,
              "bsdfs": [{"type": "diffuse", "reflectance": [0.7, 0.2, 0.2]},
                        {"type": "roughconductor", "material": "Au", "alpha": 0.2}]}


def shading_scenes():
    """The scenes of the shading phase, compiled on the card."""
    import numpy as np

    from mitsuba_path_guiding_torch.scene import scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    env = scenes.furnace(albedo=0.5, env_radiance=1.0)
    env["emitters"] = [{"type": "envmap", "image": np.ones((16, 32, 3), np.float32)}]
    mask = scenes.cornell_box()
    mask["shapes"][5]["bsdf"] = MASK_BSDF
    removed = scenes.cornell_box()
    del removed["shapes"][5]
    nested = scenes.cornell_box()
    nested["shapes"][4]["bsdf"] = BLEND_BSDF
    nested["shapes"][5]["bsdf"] = dict(MASK_BSDF, opacity=0.4)
    descs = {"furnace": scenes.furnace(albedo=0.5, env_radiance=1.0), "furnace_env": env,
             "cornell_glass": scenes.cornell_box(box_material="glass"),
             "cornell_mirror": scenes.cornell_box(box_material="mirror"),
             "cornell_mask": mask, "cornell_removed": removed, "cornell_nested": nested}
    return {k: build_scene(v, device=DEVICE) for k, v in descs.items()}


def glass_bounce_rays(scene, gen):
    """The first refracted bounce of the glass box: the camera rays of one
    256x256 wave that hit the glass, refracted at the hit into the box
    (origins 1e-4 inside), with a third of the tmax unbounded, a third
    short and a third dead."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas
    from mitsuba_path_guiding_torch.core.math import dot
    from mitsuba_path_guiding_torch.scene.types import BSDFType

    o, d, _ = camera_rays(scene, 1, 0)
    hit = intersect_pallas(scene.geo, o, d)
    row = scene.geo.shade_packed[hit.prim.clamp_min(0).long()]
    mid = row[:, 18].long()
    glass = hit.valid & (scene.mats.type[mid] == BSDFType.DIELECTRIC)
    ng = row[:, 0:3]
    n_f = ng * -torch.sign(dot(ng, d))[:, None]
    cos_i = -dot(d, n_f)
    eta = 1.0 / scene.mats.eta[mid, 0]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    t_dir = eta[:, None] * d + (eta * cos_i - torch.sqrt(k.clamp_min(0.0)))[:, None] * n_f
    p = o + hit.t[:, None] * d
    sel = glass & (k > 0.0)
    o2, d2 = (p - n_f * 1e-4)[sel], torch.nn.functional.normalize(t_dir[sel], dim=-1)
    m = o2.shape[0]
    pick = torch.randint(0, 3, (m,), generator=gen, device=o.device)
    tmax = torch.where(pick == 0, 3.0e37, torch.where(
        pick == 1, 1.5 * torch.rand((m,), generator=gen, device=o.device), -1.0))
    return o2, d2, tmax


def area_sample_witness(row, p, u):
    """The area-light branch of ``emitter.sample_direct``, op for op, on
    the CPU inputs ``row`` (32, N), ``p`` and ``u``: each op runs on the
    CPU and, on a copy of the same inputs, on the card.  Returns, for each
    op, the share of lanes where one of its uses gave the card other bits
    than the CPU; the (N,) mask of lanes where any op did; and the CPU's
    distance and pdf, which must be sample_direct's.  ``rounding`` says
    which side's sqrt of dist^2 is correctly rounded: the share of lanes
    where each differs from the float64 root rounded to float32."""
    import torch

    masks = {}

    def op(name, f, *args):
        want = f(*args)
        got = f(*(a.to(DEVICE) for a in args)).cpu()
        diff = (got != want) & ~(torch.isnan(got) & torch.isnan(want))
        diff = diff.reshape(p.shape[0], -1).any(dim=-1)
        masks[name] = masks.get(name, torch.zeros_like(diff)) | diff
        return want

    mul, add, sub = torch.mul, torch.add, torch.sub

    def dot(a, b):
        xy = op("add", add, op("mul", mul, a[..., 0], b[..., 0]), op("mul", mul, a[..., 1], b[..., 1]))
        return op("add", add, xy, op("mul", mul, a[..., 2], b[..., 2]))

    su = op("sqrt", torch.sqrt, op("clamp_min", lambda x: torch.clamp_min(x, 0.0), u[..., 1]))
    b0 = op("sub", lambda x: 1.0 - x, su)
    b1 = op("mul", mul, u[..., 2], su)
    q = torch.stack([op("add", add, op("add", add, row[14 + k], op("mul", mul, b0, row[17 + k])),
                        op("mul", mul, b1, row[20 + k])) for k in range(3)], dim=-1)
    ng = torch.stack([row[23], row[24], row[25]], dim=-1)
    to_q = op("sub", sub, q, p)
    dist2 = op("clamp_min", lambda x: torch.clamp_min(x, 1e-12), dot(to_q, to_q))
    dist = op("sqrt", torch.sqrt, dist2)
    dir_a = op("div", lambda a, b: a / b[..., None], to_q, dist)
    cos_l = dot(ng, -dir_a)
    den = op("clamp_min", lambda x: torch.clamp_min(x, 1e-12),
             op("mul", mul, torch.abs(cos_l), torch.clamp_min(row[13], 1e-12)))
    pdf = op("div", torch.div, op("mul", mul, row[1], dist2), den)
    flagged = torch.stack(list(masks.values())).any(dim=0)
    exact = torch.sqrt(dist2.double()).float()
    rounding = {"card_sqrt_off": float((torch.sqrt(dist2.to(DEVICE)).cpu() != exact).float().mean()),
                "cpu_sqrt_off": float((dist != exact).float().mean())}
    return {k: float(m.float().mean()) for k, m in masks.items()}, flagged, rounding, dist, pdf


def phase_shading_kernel_checks(sc, veach):
    """intersect_tiled bit-equal to tiled_plain on the furnace sphere's
    camera wave and on the glass box's first refracted bounce;
    gather_rows_t bit-equal on a material table with nested rows (and on
    the nested rows' indices); sample_direct on veach_mis's 3840-emitter
    table against its CPU result."""
    import torch

    from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
    from mitsuba_path_guiding_torch.models.emitter import kinds_present, sample_direct
    from mitsuba_path_guiding_torch.ops.gather import gather_rows_t, gather_rows_t_plain
    from mitsuba_path_guiding_torch.scene.types import EmitterKind as K
    from mitsuba_path_guiding_torch.scene.types import Emitters, Geometry

    dev = DEVICE
    gen = torch.Generator(device=dev).manual_seed(5)
    res = {}
    fur = sc["furnace"]
    o, d, _ = camera_rays(fur, 1, 0)
    tmax = torch.full((o.shape[0],), 3.0e37, device=dev)
    res["intersect_tiled_furnace_camera"] = tiled_check(
        fur.geo, o, d, tmax, fur.geo.p0.shape[0], "furnace camera")
    glass = sc["cornell_glass"]
    o, d, tmax = glass_bounce_rays(glass, gen)
    check(o.shape[0] > 1000, f"glass bounce: only {o.shape[0]} rays refracted")
    res["intersect_tiled_glass_bounce"] = tiled_check(
        glass.geo, o, d, tmax, glass.geo.p0.shape[0], "glass refracted bounce")

    mats = sc["cornell_nested"].mats
    r = mats.packed.shape[0]
    for dtype in (torch.int64, torch.int32):
        idx = torch.randint(-3, r + 3, (524288,), generator=gen, device=dev).to(dtype)
        got = gather_rows_t(mats.packed, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, gather_rows_t_plain(mats.packed, idx)),
              f"gather_rows_t nested table {dtype}: not bit-equal")
    mid = torch.randint(0, r, (524288,), generator=gen, device=dev).to(torch.int32)
    types = bsdf_mod.types_present(mats)
    p = bsdf_mod.gather_params(mats, mid, types=types)
    sub = torch.cat([p.sub_a.clamp_min(0), p.sub_b.clamp_min(0)])
    check(torch.equal(gather_rows_t(mats.packed, sub), gather_rows_t_plain(mats.packed, sub)),
          "gather_rows_t nested rows: not bit-equal")
    pa_plain = mats.packed[p.sub_a.clamp_min(0).long(), 1:4]
    check(torch.equal(p.nested[0].refl, pa_plain), "gather_params nested row A differs")
    res["gather_rows_t_nested"] = {"table": f"{r}x32", "types": list(types),
                                   "nested_rows": int((p.sub_a >= 0).sum()), "bit_equal": True}

    em, geo = veach.emitters, veach.geo
    n = 65536
    lo, hi = veach.aabb_min, veach.aabb_max
    pts = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=dev)
    u = torch.rand((n, 3), generator=gen, device=dev)
    kinds = kinds_present(em)
    got = sample_direct(em, geo, pts, u, kinds=kinds)
    want = sample_direct(Emitters(*(x.cpu() for x in em)),
                         Geometry(*(None if x is None else x.cpu() for x in geo)),
                         pts.cpu(), u.cpu(), kinds=kinds)
    check(torch.equal(got.emitter_id.cpu(), want.emitter_id), "veach sample_direct: emitter ids")
    check(torch.equal(got.is_delta.cpu(), want.is_delta), "veach sample_direct: delta flags")
    check(set(kinds) == {K.AREA}, f"veach sample_direct: kinds {kinds}, the witness covers AREA")
    eid = want.emitter_id.long()
    shares, flagged, rounding, w_dist, w_pdf = area_sample_witness(em.packed.cpu()[eid].T.contiguous(),
                                                                   pts.cpu(), u.cpu())
    check(torch.equal(w_dist, want.distance) and torch.equal(w_pdf, want.pdf),
          "veach sample_direct: the witness does not retrace the CPU's area branch")
    errs, equal, unexplained = {}, {}, {}
    for f in ("direction", "distance", "radiance", "pdf"):
        a, b = getattr(got, f).cpu(), getattr(want, f)
        errs[f] = float((a - b).abs().max())
        same = (a == b).reshape(n, -1).all(dim=-1)
        equal[f] = float(same.float().mean())
        unexplained[f] = int((~same & ~flagged).sum())
        check(equal[f] >= SAMPLE_DIRECT_MIN_EQUAL,
              f"veach sample_direct: {f} bit-equal on only {equal[f]} of the lanes")
        check(unexplained[f] == 0,
              f"veach sample_direct: {f} differs on {unexplained[f]} lanes where every op agrees")
        check(bool(torch.allclose(a, b, rtol=SAMPLE_DIRECT_RTOL[f], atol=1e-6)),
              f"veach sample_direct: {f} off its CPU result by up to {errs[f]}")
    res["sample_direct_veach"] = {"emitters": int(em.kind.shape[0]), "lanes": n,
                                  "check": "ids and flags equal; every field bit-equal on at "
                                           f"least {SAMPLE_DIRECT_MIN_EQUAL} of the lanes and "
                                           "on every lane where each op of the witness agrees; "
                                           f"the rest within {SAMPLE_DIRECT_RTOL} (rtol)",
                                  "max_abs_err": errs, "bit_equal_share": equal,
                                  "witness_op_differs_share": shares,
                                  "witness_lanes_flagged": int(flagged.sum()),
                                  "witness_sqrt_rounding": rounding,
                                  "unexplained_lanes": unexplained}
    emit({"phase": "shading_kernel_checks", **res})
    return res


def render_counted(scene, cfg, fn=None):
    """integrators.render.render (or fn(scene, cfg), which calls it) with
    the path segments of its waves summed (render_wave wrapped).  Returns
    (image, seconds, segments)."""
    import torch

    from mitsuba_path_guiding_torch.integrators import render as rmod

    real = rmod.render_wave
    segs = []

    def counted(*a, **kw):
        film_xy, L, aux = real(*a, **kw)
        segs.append(aux.n_bounces.sum())
        return film_xy, L, aux

    rmod.render_wave = counted
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        img = (fn or rmod.render)(scene, cfg)
        torch.cuda.synchronize()
        dt = time.time() - t0
    finally:
        rmod.render_wave = real
    return img, dt, int(sum(int(s) for s in segs))


def phase_furnace(scene, name, use_nee, card):
    """The white furnace at 256x256, unguided render(): the top rows see the
    unit environment (1 +- 1e-3), the sphere's centre albedo x env (0.5 +-
    0.02 with NEE, +- 1e-4 without, where cosine sampling is
    zero-variance)."""
    import torch

    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    spp = FURNACE_SPP[use_nee]
    img, dt, segs = render_counted(scene, RenderConfig(width=SHADE_W, height=SHADE_H, spp=spp,
                                                       max_depth=DEPTH, use_nee=use_nee))
    check(bool(torch.isfinite(img).all()), f"{name}: image not finite")
    border = float(img[:FURNACE_BORDER_ROWS].mean())
    centre = float(img[FURNACE_CENTRE, FURNACE_CENTRE].mean())
    if use_nee:
        check(abs(border - 1.0) < 1e-3, f"{name}: border {border}, expected 1 +- 1e-3")
    tol = FURNACE_TOL[use_nee]
    check(abs(centre - 0.5) < tol, f"{name}: centre {centre}, expected 0.5 +- {tol}")
    rays = segs * (2 if use_nee else 1)
    emit({"phase": name, "card": card, "spp": spp, "use_nee": use_nee, "seconds": round(dt, 3),
          "border_mean": border, "centre_mean": centre, "centre_tol": tol,
          "mrays_per_s": rays / dt / 1e6})


def phase_reference_progressive(scene, name, width, height, card, ref=None, accel="auto",
                                **pcfg):
    """ProgressiveRenderer at width x height, depth 5, 4 spp x 4, guided: the
    image finite, non-black, its mean within max(3%, 4 standard errors) of
    the JAX reference (``ref`` = (mean, se), else SHADING_REFERENCE; the
    card's standard error from the four progressions' own means), and the
    grid with valid cells.  ``accel`` is the route, ``pcfg`` more
    ProgressiveConfig fields.  Returns the image."""
    import torch

    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    ref, ref_se = SHADING_REFERENCE[name] if ref is None else ref
    cfg = ProgressiveConfig(render=RenderConfig(width=width, height=height, spp=0,
                                                max_depth=DEPTH, accel=accel),
                            samples_per_progression=4, n_progressions=4, guiding=True,
                            grid_res=16, n_lobes=8, **pcfg)
    renderer = ProgressiveRenderer(scene, cfg)
    cum = []
    run = renderer.run_progression

    def run_and_record():
        run()
        rgbw = renderer.film.rgb_weight
        cum.append(float((rgbw[:, 0:3] / rgbw[:, 3:4].clamp_min(1e-8)).mean()))

    renderer.run_progression = run_and_record
    torch.cuda.synchronize()
    t0 = time.time()
    img = renderer.render()
    torch.cuda.synchronize()
    dt = time.time() - t0
    mean = float(img.mean())
    n_valid = int(renderer.grid.valid.sum())
    check(bool(torch.isfinite(img).all()), f"{name}: image not finite")
    check(mean > 0.0, f"{name}: image is black")
    check(n_valid > 0, f"{name}: guiding grid has no valid cells")
    own = [(k + 1) * cum[k] - k * cum[k - 1] if k else cum[0] for k in range(len(cum))]
    se_card = statistics.stdev(own) / len(own) ** 0.5
    tol = max(MEAN_TOL, 4.0 * (ref_se**2 + se_card**2) ** 0.5 / ref)
    rel = abs(mean - ref) / ref
    check(rel < tol, f"{name}: mean {mean} vs reference {ref} (tol {tol})")
    segs = renderer.stats.get("rays traced") / 2
    emit({"phase": name, "card": card, "resolution": f"{width}x{height}",
          "seconds": round(dt, 3), "mean": mean, "reference_mean": ref, "reference_se": ref_se,
          "rel_err": rel, "rel_tol": tol, "se_card": se_card, "progression_means": own,
          "valid_cells": n_valid, "spp": renderer.sample_counter,
          "mrays_per_s": 2 * segs / dt / 1e6, "accel": accel, **pcfg})
    return img


def phase_mask(scene, removed_mean, accel, card):
    """The Cornell box with an opacity-0 mask on the tall box, unguided
    render() at 256x256 x 8 spp, depth 9, through ``accel``: its mean
    within 5% of the Cornell box without the tall box."""
    import torch

    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    cfg = RenderConfig(width=SHADE_W, height=SHADE_H, spp=MASK_SPP, max_depth=MASK_DEPTH,
                       seed=1, accel=accel)
    img, dt, segs = render_counted(scene, cfg)
    check(bool(torch.isfinite(img).all()), f"mask ({accel}): image not finite")
    mean = float(img.mean())
    rel = abs(mean - removed_mean) / removed_mean
    check(rel < MASK_TOL, f"mask ({accel}): mean {mean} vs {removed_mean} without the box")
    emit({"phase": f"cornell_mask_{accel}", "card": card, "spp": MASK_SPP,
          "max_depth": MASK_DEPTH, "seconds": round(dt, 3), "mean": mean,
          "without_box_mean": removed_mean, "rel_err": rel, "rel_tol": MASK_TOL,
          "mrays_per_s": 2 * segs / dt / 1e6})


def run_shading(sc, veach, card):
    """The shading phase's routes, each between its own launch-count reset
    and read.  Returns their launch counts by route."""
    import torch

    from mitsuba_path_guiding_torch.integrators.render import PIXEL_BATCH, RenderConfig, render

    def waves(w, h, spp):
        return -(-w * h // PIXEL_BATCH) * spp

    def tiled(n_waves, depth=DEPTH, nee=True, gathers=3, shadow=1, large=0, bvh=False):
        """A wavefront route: a closest-hit query a bounce and, with NEE,
        ``shadow`` more; ``gathers`` fetches a bounce, ``large`` of them on
        tables of more than 512 rows."""
        queries = n_waves * depth * (1 + (shadow if nee else 0))
        return {**NONE_LAUNCHED, "intersect_bvh" if bvh else "intersect_tiled": queries,
                "gather_rows_t": n_waves * depth * gathers,
                "gather_rows_t_large": n_waves * depth * large}

    counts = {}
    fw = {nee: waves(SHADE_W, SHADE_H, FURNACE_SPP[nee]) for nee in (True, False)}
    for name in ("furnace", "furnace_env"):
        for nee in (True, False):
            route = f"{name}_{'nee' if nee else 'bsdf'}"
            # the 9024-row shading table is a large one
            _, counts[route] = drive(route, lambda: phase_furnace(sc[name], route, nee, card),
                                     tiled(fw[nee], nee=nee, gathers=3 if nee else 2,
                                           large=1))
    cw = waves(SHADE_W, SHADE_H, 16)
    for name in ("cornell_glass", "cornell_mirror"):
        _, counts[name] = drive(name, lambda: phase_reference_progressive(
            sc[name], name, SHADE_W, SHADE_H, card), tiled(cw))
    torch.cuda.synchronize()
    removed = render(sc["cornell_removed"], RenderConfig(width=SHADE_W, height=SHADE_H,
                                                         spp=MASK_SPP, max_depth=MASK_DEPTH,
                                                         seed=1))
    removed_mean = float(removed.mean())
    mw = waves(SHADE_W, SHADE_H, MASK_SPP)
    for accel in ("auto", "bvh"):
        # a bounce: shading, material, nested material and emitter rows,
        # and the shadow march's four closest hits, each with its shading
        # and material rows
        _, counts[f"cornell_mask_{accel}"] = drive(
            f"cornell_mask_{accel}", lambda: phase_mask(sc["cornell_mask"], removed_mean, accel,
                                                        card),
            tiled(mw, depth=MASK_DEPTH, gathers=4 + 2 * 4, shadow=4, bvh=accel == "bvh"))
    # veach_mis: the 3850-row shading table and the 3840-row emitter table
    # are large ones
    _, counts["veach_mis"] = drive("veach_mis", lambda: phase_reference_progressive(
        veach, "veach_mis", VEACH_W, VEACH_H, card), tiled(waves(VEACH_W, VEACH_H, 16), large=2))
    return counts


# ---------------------------------------------------------------------------
# the scene vocabulary: coats and the HK slab, sun and sky, every sensor,
# the samplers and the reconstruction filters
# ---------------------------------------------------------------------------

# the tall box's material, from cornell_box()'s white diffuse row
VOCAB_BSDFS = {
    "cornell_coating": lambda white: {"type": "coating", "bsdf": white},
    "cornell_roughcoating": lambda white: {"type": "roughcoating", "alpha": 0.1, "bsdf": white},
    "cornell_hk": lambda white: {"type": "hk"},
}
VOCAB_SENSORS = ("orthographic", "spherical", "thinlens", "telecentric")


def vocabulary_descs(mod):
    """The vocabulary phase's scene descriptions, built from ``mod``'s
    ``cornell_box()`` and ``look_at`` (the port's scenes module here, the
    JAX package's in tools/shading_reference_means.py): the Cornell box
    with a coated, rough-coated or HK tall box; the plane of the JAX
    package's tests/test_sunsky.py under ``sky``, ``sun`` and ``sunsky``;
    the Cornell box through four sensors (orthographic and telecentric of
    half-width 1 from the pinhole's place, a thin lens focused on the
    boxes, a spherical camera inside the box)."""
    descs = {}
    for name, make in VOCAB_BSDFS.items():
        sc = mod.cornell_box()
        sc["shapes"][5]["bsdf"] = make(sc["shapes"][5]["bsdf"])
        descs[name] = sc
    for etype in ("sky", "sun", "sunsky"):
        # azimuth 180 puts the sun on the camera's side of the plane
        descs[etype] = {"sensor": {"type": "perspective", "fov": 60.0},
                        "shapes": [{"type": "rectangle", "bsdf": {"type": "diffuse"}}],
                        "emitters": [{"type": etype, "elevation": 35.0, "azimuth": 180.0,
                                      "turbidity": 3.0}]}
    sensors = {
        "orthographic": {"type": "orthographic", "ortho_width": 1.0},
        "telecentric": {"type": "telecentric", "ortho_width": 1.0, "aperture_radius": 0.05,
                        "focus_distance": 3.7},
        "thinlens": {"type": "thinlens", "aperture_radius": 0.1, "focus_distance": 3.7},
        "spherical": {"type": "spherical", "to_world": mod.look_at([0, 1.0, 0.0], [0, 1.0, 1.0])},
    }
    for kind in VOCAB_SENSORS:
        sc = mod.cornell_box()
        sc["sensor"] = {**sc["sensor"], **sensors[kind]}
        descs[f"cornell_{kind}"] = sc
    return descs


VOCAB_SPP = 16                        # 4 groups of 4 spp, or 4 spp x 4 progressions
VOCAB_GROUPS = 4
SAMPLER_NAMES = ("stratified", "halton", "hammersley", "sobol", "ldsampler")
QMC_BOUNCES = 2
SAMPLER_REF_SPP = 512                 # the independent image relMSE is read against
FILTER_NAMES = ("box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos")
FILTER_SPP = 8
METER_W = METER_H = 64
METER_SPP = 4
METER_TOL = 0.05
METER_EXPECT = {"radiancemeter": 2.0, "irradiancemeter": 2.0 * 3.141592653589793,
                "fluencemeter": 8.0 * 3.141592653589793}


def meter_desc(stype):
    """A probe at the origin in a constant environment of radiance 2 (the
    JAX package's tests/test_sensors_meters.py); the far sphere never
    blocks it."""
    from mitsuba_path_guiding_torch.scene.scenes import look_at

    return {"sensor": {"type": stype, "to_world": look_at([0, 0, 0], [0, 0, 1])},
            "shapes": [{"type": "sphere", "center": [0, 100, 0], "radius": 0.5,
                        "bsdf": {"type": "diffuse", "reflectance": [0.5] * 3}}],
            "emitters": [{"type": "constant", "radiance": [2.0, 2.0, 2.0]}]}


def vocabulary_scenes():
    """The vocabulary phase's scenes, compiled on the card."""
    from mitsuba_path_guiding_torch.scene import scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    descs = vocabulary_descs(scenes)
    descs.update({stype: meter_desc(stype) for stype in METER_EXPECT})
    return {k: build_scene(v, device=DEVICE) for k, v in descs.items()}


def phase_vocabulary_kernel_checks(vs, card):
    """gather_rows_t on the coat transmittance table (the rough-coated
    Cornell box's, (M, 16): the kernel's general path) bit-equal to its
    plain version, on a wave of random rows and on the material ids of a
    camera wave's hits, with its CUDA-event median of 7; intersect_tiled
    bit-equal on the sunsky plane's camera wave."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas
    from mitsuba_path_guiding_torch.ops.gather import gather_rows_t, gather_rows_t_plain

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    table = vs["cornell_roughcoating"].mats.coat_trans
    check(table.shape[1] == 16 and int((table.amax(dim=1) > 0).sum()) == 1,
          f"coat table {tuple(table.shape)}: expected one coat row of 16 columns")
    # the timed calls take rows in range (torch.index_select, the library
    # call beside them, refuses others); the kernel clamps the rest
    idx = torch.randint(-3, table.shape[0] + 3, (W * H,), generator=gen, device=DEVICE)
    check(torch.equal(gather_rows_t(table, idx), gather_rows_t_plain(table, idx)),
          "gather_rows_t coat table, rows out of range: not bit-equal")
    random_call = gather_call(table, idx.clamp(0, table.shape[0] - 1).to(torch.int32))
    sc = vs["cornell_roughcoating"]
    o, d, _ = camera_rays(sc, 1, 0)
    hit = intersect_pallas(sc.geo, o, d)
    mid = sc.geo.shade_packed[hit.prim.clamp_min(0).long(), 18].to(torch.int32)
    wave_call = gather_call(table, mid)
    sky = vs["sunsky"]
    o, d, _ = camera_rays(sky, 1, 0)
    tmax = torch.full((o.shape[0],), 3.0e37, device=DEVICE)
    tiled = tiled_check(sky.geo, o, d, tmax, sky.geo.p0.shape[0], "sunsky camera")
    res = {"gather_rows_t_coat_random": random_call, "gather_rows_t_coat_wave": wave_call,
           "intersect_tiled_sunsky_camera": tiled}
    emit({"phase": "vocabulary_kernel_checks", "card": card, **res})
    return res


def render_groups(scene, name, cfg, card, ref=None, groups=VOCAB_GROUPS):
    """integrators.render.render in ``groups`` runs of cfg.spp, seeds 0 up:
    the groups' mean image, and the mean and standard error of their
    image means.  With ``ref`` = (mean, se) the mean is held within
    max(3%, 4 sqrt(se_ref^2 + se^2)) of it.  Returns (image, mean,
    record)."""
    import torch

    means, imgs, secs, segs = [], [], 0.0, 0
    for g in range(groups):
        img, dt, sg = render_counted(scene, cfg._replace(seed=g))
        check(bool(torch.isfinite(img).all()), f"{name}: image not finite")
        means.append(float(img.mean()))
        imgs.append(img)
        secs, segs = secs + dt, segs + sg
    mean = statistics.fmean(means)
    se = statistics.stdev(means) / len(means) ** 0.5 if groups > 1 else 0.0
    rec = {"phase": name, "card": card, "resolution": f"{cfg.width}x{cfg.height}",
           "spp": cfg.spp * groups, "sampler": cfg.sampler, "qmc_bounces": cfg.qmc_bounces,
           "filter": cfg.filter_name, "seconds": round(secs, 3), "mean": mean, "se": se,
           "group_means": means, "mrays_per_s": 2 * segs / secs / 1e6}
    if ref is not None:
        check(mean > 0.0, f"{name}: image is black")
        tol = max(MEAN_TOL, 4.0 * (ref[1] ** 2 + se ** 2) ** 0.5 / ref[0])
        rel = abs(mean - ref[0]) / ref[0]
        check(rel < tol, f"{name}: mean {mean} vs reference {ref[0]} (tol {tol})")
        rec.update(reference_mean=ref[0], reference_se=ref[1], rel_err=rel, rel_tol=tol)
    return torch.stack(imgs).mean(dim=0), mean, rec


def run_vocabulary(vs, cornell, card):
    """The vocabulary phase's renders, each between its own launch-count
    reset and read, held to the kernels it must launch.  Returns their
    launch counts by route."""
    import torch

    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    cfg = RenderConfig(width=SHADE_W, height=SHADE_H, spp=VOCAB_SPP // VOCAB_GROUPS,
                       max_depth=DEPTH)
    waves = VOCAB_SPP  # 256x256 is one wave a sample

    def wavefront(n_waves, gathers=3, large=0):
        return {**NONE_LAUNCHED, "intersect_tiled": 2 * DEPTH * n_waves,
                "gather_rows_t": gathers * DEPTH * n_waves,
                "gather_rows_t_large": large * DEPTH * n_waves}

    def fused(n_waves):
        return {**NONE_LAUNCHED, "trace_fused": n_waves}

    counts, records = {}, {}
    # a coat's bounce: shading, material, nested and emitter rows and the
    # coat table's row; HK's: shading, material and emitter rows
    for name in VOCAB_BSDFS:
        _, counts[name] = drive(name, lambda: phase_reference_progressive(
            vs[name], name, SHADE_W, SHADE_H, card),
            wavefront(waves, gathers=3 if name == "cornell_hk" else 5))
    for name in ("sky", "sun", "sunsky"):
        (_, _, records[name]), counts[name] = drive(
            name, lambda: render_groups(vs[name], name, cfg, card, SHADING_REFERENCE[name]),
            wavefront(waves))
        emit(records[name])
    for kind in VOCAB_SENSORS:
        name = f"cornell_{kind}"
        (_, _, records[name]), counts[name] = drive(
            name, lambda: render_groups(vs[name], name, cfg, card, SHADING_REFERENCE[name]),
            fused(waves))
        emit(records[name])
    for stype, expect in METER_EXPECT.items():
        mcfg = RenderConfig(width=METER_W, height=METER_H, spp=METER_SPP, max_depth=DEPTH)
        # the probe's far sphere is a large shading table (9024 rows)
        (_, mean, rec), counts[stype] = drive(
            stype, lambda: render_groups(vs[stype], stype, mcfg, card, groups=1),
            wavefront(METER_SPP, large=1))
        rel = abs(mean / expect - 1.0)
        check(rel < METER_TOL, f"{stype}: {mean}, expected {expect} within {METER_TOL}")
        emit({**rec, "expected": expect, "rel_err": rel, "rel_tol": METER_TOL})

    # the samplers, against a high-spp independent image (the fused route),
    # each in one render of VOCAB_SPP samples: a sampler's sequence (the
    # stratified grid too) runs over one render's sample indices
    from mitsuba_path_guiding_torch.integrators.render import render

    ref_cfg = cfg._replace(spp=SAMPLER_REF_SPP, seed=99)
    ref_img, c_ref = drive("sampler_reference", lambda: render(cornell, ref_cfg),
                           fused(SAMPLER_REF_SPP))
    counts["sampler_reference"] = c_ref
    ref_mean = (CORNELL_REFERENCE_MEAN, CORNELL_REFERENCE_SE)
    rel_mse = {}
    for smp in ("independent",) + SAMPLER_NAMES + ("sobol_qmc",):
        scfg = cfg._replace(spp=VOCAB_SPP, sampler="sobol" if smp == "sobol_qmc" else smp,
                            qmc_bounces=QMC_BOUNCES if smp == "sobol_qmc" else 0)
        name = f"sampler_{smp}"
        (img, _, rec), counts[name] = drive(
            name, lambda: render_groups(cornell, name, scfg, card, ref_mean, groups=1),
            fused(waves) if smp == "independent" else wavefront(waves))
        rel_mse[smp] = relmse(img, ref_img)
        emit({**rec, "relmse": rel_mse[smp], "reference_spp": SAMPLER_REF_SPP})
    emit({"phase": "sampler_relmse", "card": card, "spp": VOCAB_SPP,
          "reference_spp": SAMPLER_REF_SPP, "relmse": rel_mse,
          "qmc_bounces_over_independent": rel_mse["sobol_qmc"] / rel_mse["independent"]})
    for filt in FILTER_NAMES:
        name = f"filter_{filt}"
        fcfg = cfg._replace(spp=FILTER_SPP, filter_name=filt)
        (_, _, rec), counts[name] = drive(
            name, lambda: render_groups(cornell, name, fcfg, card, ref_mean, groups=1),
            fused(FILTER_SPP))
        emit(rec)
    torch.cuda.synchronize()
    return counts



# ---------------------------------------------------------------------------
# volumes: homogeneous and grid media, every phase family, guided distance
# sampling, render_scanned and the firefly clamp
# ---------------------------------------------------------------------------

VOL_PHASES = {
    "rayleigh": {"phase": "rayleigh"},
    "kkay": {"phase": "kkay", "orientation": [0.3, 0.5, 0.81], "ks": 0.4, "kd": 0.2,
             "exponent": 4.0},
    "microflake": {"phase": "microflake", "orientation": [0.0, 0.0, 1.0], "stddev": 0.25},
    "mixture": {"phase": "mixture", "phase_weights": [0.5, 0.3, 0.2],
                "phase_components": [{"type": "hg", "g": 0.6}, {"type": "rayleigh"},
                                     {"type": "hg", "g": -0.4}]},
}


def volume_descs(mod):
    """The volumes phase's scene descriptions from ``mod``'s scenes (the
    port's here, the JAX package's in tools/volume_reference_means.py):
    the CLI's ``volbox`` (volumetric_box(), HG g 0.3), the grid box
    (heterogeneous_box(), a 32^3 cloud) and volumetric_box(sigma_s=0.6,
    sigma_a=0.1) with each phase family but HG."""
    descs = {"volbox": mod.volumetric_box(), "grid_box": mod.heterogeneous_box()}
    for kind, patch in VOL_PHASES.items():
        sc = mod.volumetric_box(sigma_s=0.6, sigma_a=0.1)
        sc["medium"].update(patch)
        descs[f"volbox_{kind}"] = sc
    return descs


# JAX package CPU means (unguided, rr_depth = max_depth, 128x128, 8 groups
# of 8 spp: mean, standard error) of volume_descs' scenes by
# tools/volume_reference_means.py; "volbox_d8" is the volbox at depth 8,
# the rest depth 5; one run of 47.2 s
VOLUME_REFERENCE = {
    "volbox": (0.040754490066319704, 0.0001345337379296268),
    "grid_box": (0.1146809533238411, 0.00019487206616611736),
    "volbox_rayleigh": (0.026597939897328615, 0.00021774932968299783),
    "volbox_kkay": (0.014301253017038107, 0.0001831388342475459),
    "volbox_microflake": (0.08057150989770889, 0.00037912446575555847),
    "volbox_mixture": (0.03137351805344224, 0.00012581882219315986),
    "volbox_d8": (0.04627908393740654, 0.00014091131329908887),
}
VOL_W = VOL_H = 256               # the CLI's default resolution
VOL_SMALL = 128                   # the phase-family, scanned and clamp renders
VOL_PHASE_SPP = 16                # 4 groups of 4 spp
VOL_BENCH_DEPTH = 8               # bench.py's volumetric recipe: depth 8,
VOL_BENCH_SPP_WAVE = 4            # 4 spp a wave (262144 lanes),
VOL_BENCH_WAVES = 8               # 8 waves
VOL_RELMSE_REF_SPP = 64           # the unguided card image the guided renders are read against
VOL_CLAMP = 0.5                   # max_component_value of the clamp check
VOL_SYNC_WAVES = 2                # waves whose host syncs are counted, after one warm-up


def volume_scenes():
    from mitsuba_path_guiding_torch.scene import scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    return {name: build_scene(desc, device=DEVICE) for name, desc in volume_descs(scenes).items()}


def volume_event_rays(scene):
    """A volbox camera wave's first medium events, as trace_vol samples
    them (its bounce-0 uniforms, the channel's exponential distance), and
    the rays leaving them: origins in mid-air with no surface offset, in
    HG-sampled directions (tmax unbounded) and toward NEE samples of the
    light (tmax = distance (1 - 1e-3), as trace_vol's shadow rays)."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas
    from mitsuba_path_guiding_torch.core.rng import bounce_uniform
    from mitsuba_path_guiding_torch.models.emitter import kinds_present, sample_direct
    from mitsuba_path_guiding_torch.models.phase import phase_sample

    o, d, rkeys = camera_rays(scene, 1, 0)
    hit = intersect_pallas(scene.geo, o, d)
    t_surf = torch.where(hit.valid, hit.t, 3.0e37)
    med = scene.medium
    sigma_t = med.sigma_a + med.sigma_s
    u = bounce_uniform(rkeys, 0, 12)
    ch = torch.clamp((u[..., 9] * 3.0).to(torch.int64), 0, 2)
    t_med = -torch.log(torch.clamp_min(1.0 - u[..., 10], 1e-12)) / torch.clamp_min(sigma_t[ch],
                                                                                   1e-12)
    ev = t_med < t_surf
    p = (o + t_med[..., None] * d)[ev]
    wo, _ = phase_sample(-d[ev], med.phase_g, u[ev][..., 3:5])
    ds = sample_direct(scene.emitters, scene.geo, p, u[ev][..., 0:3],
                       kinds=kinds_present(scene.emitters))
    t_sh = torch.where(ds.distance >= 3.0e37, 3.0e37, ds.distance * (1.0 - 1e-3))
    inf = torch.full((p.shape[0],), 3.0e37, device=p.device)
    return {"scatter": (p, wo, inf), "shadow": (p, ds.direction, t_sh)}


def phase_volume_kernel_checks(vs, card):
    """On a volbox wave's medium-event rays (volume_event_rays):
    intersect_tiled against tiled_plain and the BVH kernel against
    bvh_plain, closest hit and any-hit, every output bit equal on every
    lane; gather_rows_t bit-equal on the shading rows of their hits, timed
    as gather_call times it."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_cuda, bvh_plain

    sc = vs["volbox"]
    geo = sc.geo
    sets = volume_event_rays(sc)
    res = {}
    for label, (o, d, tmax) in sets.items():
        check(o.shape[0] > 10000, f"volbox {label}: only {o.shape[0]} medium events")
        res[f"intersect_tiled_volbox_{label}"] = tiled_check(geo, o, d, tmax, geo.p0.shape[0],
                                                             f"volbox {label}")
        for any_hit in (False, True):
            got = bvh_cuda(sc.bvh, o, d, tmax, any_hit)
            want = bvh_plain(sc.bvh, o, d, tmax, any_hit)
            torch.cuda.synchronize()
            differ = [int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, want)]
            check(not any(differ), f"bvh volbox {label} any_hit={any_hit}: lanes differing by "
                                   f"output {differ}")
            res[f"bvh_volbox_{label}_{'any' if any_hit else 'closest'}"] = {
                "rays": o.shape[0], "bit_equal": True,
                "hit_share": float((got[1] >= 0).float().mean())}
    o, d, tmax = sets["scatter"]
    prim = bvh_cuda(sc.bvh, o, d, tmax, False)[1]
    res["gather_rows_t_volbox_shading"] = gather_call(geo.shade_packed,
                                                      prim.clamp_min(0).to(torch.int32))
    emit({"phase": "volume_kernel_checks", "card": card, **res})
    return res


def syncs_per_wave(fn, waves=VOL_SYNC_WAVES):
    """Host syncs of fn() (one wave), counted by torch's sync debug mode
    over ``waves`` calls after a warm-up call: (the mean a call, the mean
    a call by the port's source line that asked for them)."""
    import collections
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(waves):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    root = os.path.dirname(os.path.abspath(__file__))
    sites = collections.Counter(f"{os.path.relpath(w.filename, root)}:{w.lineno}" for w in syncs)
    return len(syncs) / waves, {k: n / waves for k, n in sites.most_common()}


def phase_volume_syncs(vs, cornell, card):
    """Host syncs a wave (syncs_per_wave) of a guided progressive wave of
    Cornell (the wavefront), the volbox and the grid box at 256x256, and
    of an unguided volbox render_wave."""
    import torch

    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render_wave

    cfg = RenderConfig(width=VOL_W, height=VOL_H, spp=0, max_depth=DEPTH)
    pix = torch.arange(VOL_W * VOL_H, device=DEVICE)
    sidx = torch.zeros_like(pix)
    res, sites = {}, {}
    for name, sc in (("cornell_wavefront", cornell), ("volbox", vs["volbox"]),
                     ("grid_box", vs["grid_box"])):
        ren = ProgressiveRenderer(sc, ProgressiveConfig(render=cfg, grid_res=16, n_lobes=8))
        res[f"{name}_guided"], sites[f"{name}_guided"] = syncs_per_wave(
            lambda: ren._wave(pix, sidx))
    res["volbox_unguided_render_wave"], sites["volbox_unguided_render_wave"] = syncs_per_wave(
        lambda: render_wave(vs["volbox"], cfg, pix, sidx))
    emit({"phase": "volume_syncs_per_wave", "card": card, "resolution": f"{VOL_W}x{VOL_H}",
          "depth": DEPTH, "waves_counted": VOL_SYNC_WAVES, "syncs_per_wave": res,
          "by_source_line": sites})
    return res


def phase_volume_bench(scene, card):
    """bench.py's volumetric recipe through render_wave: the volbox at
    256x256, depth 8 (rr_depth 8), unguided, waves of 4 spp (262144 lanes),
    8 timed waves after one warm-up wave; Mrays/s = 2 sum(n_bounces) / s;
    the image mean held to the JAX reference (its standard error from the
    waves' means)."""
    import torch

    from mitsuba_path_guiding_torch.film.film import Film, develop, new_film, splat
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render_wave

    cfg = RenderConfig(width=VOL_W, height=VOL_H, spp=0, max_depth=VOL_BENCH_DEPTH,
                       rr_depth=VOL_BENCH_DEPTH)
    n_pix = VOL_W * VOL_H
    pix = torch.arange(n_pix, device=DEVICE).repeat(VOL_BENCH_SPP_WAVE)
    spp_idx = torch.arange(VOL_BENCH_SPP_WAVE, device=DEVICE).repeat_interleave(n_pix)
    render_wave(scene, cfg, pix, spp_idx + 1000)  # warm-up, not splatted
    rgbw = new_film(VOL_W, VOL_H, device=DEVICE).rgb_weight
    segs, means = [], []
    torch.cuda.synchronize()
    t0 = time.time()
    for w in range(VOL_BENCH_WAVES):
        film_xy, L, aux = render_wave(scene, cfg, pix, spp_idx + w * VOL_BENCH_SPP_WAVE)
        rgbw = splat(rgbw, film_xy, L, VOL_W, VOL_H)
        segs.append(aux.n_bounces.sum())
        means.append(L.mean())
    torch.cuda.synchronize()
    dt = time.time() - t0
    img = develop(Film(rgb_weight=rgbw, width=VOL_W, height=VOL_H))
    n_segs = int(sum(int(x) for x in segs))
    means = [float(m) for m in means]
    mean = float(img.mean())
    se = statistics.stdev(means) / len(means) ** 0.5
    ref, ref_se = VOLUME_REFERENCE["volbox_d8"]
    check(bool(torch.isfinite(img).all()) and mean > 0.0, "volbox bench: image not finite or black")
    tol = max(MEAN_TOL, 4.0 * (ref_se**2 + se**2) ** 0.5 / ref)
    rel = abs(mean - ref) / ref
    check(rel < tol, f"volbox bench: mean {mean} vs reference {ref} (tol {tol})")
    rec = {"phase": "volbox_bench", "card": card, "resolution": f"{VOL_W}x{VOL_H}",
           "depth": VOL_BENCH_DEPTH, "lanes_per_wave": pix.numel(), "waves": VOL_BENCH_WAVES,
           "seconds": round(dt, 4), "segments": n_segs, "mrays_per_s": 2 * n_segs / dt / 1e6,
           "mean": mean, "se": se, "reference_mean": ref, "reference_se": ref_se,
           "rel_err": rel, "rel_tol": tol}
    emit(rec)
    return rec


def run_volumes(vs, cornell, card):
    """The volumes phase's renders, each between its own launch-count
    reset and read and held to the kernels it must launch: a volume bounce
    is a closest-hit and a shadow query (tiled, or the BVH with
    accel="bvh") and three gathers (shading, material and emitter rows).
    Returns their launch counts by route."""
    import torch

    from mitsuba_path_guiding_torch.integrators import render as rmod
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render, render_scanned

    def route(n_waves, depth=DEPTH, bvh=False):
        return {**NONE_LAUNCHED, "intersect_bvh" if bvh else "intersect_tiled": 2 * depth * n_waves,
                "gather_rows_t": 3 * depth * n_waves}

    counts, imgs = {}, {}
    prog_waves = 16  # 256x256 is one wave a sample: 4 spp x 4 progressions
    ref = {k: VOLUME_REFERENCE[k] for k in VOLUME_REFERENCE}
    # (a) the CLI's defaults, guided distance sampling on and off; (b) the
    # grid box; (d) the volbox through the BVH
    for name, scene_name, kw in (
            ("volbox_guided", "volbox", {"guide_distance": True}),
            ("volbox_guided_no_distance", "volbox", {"guide_distance": False}),
            ("grid_box_guided", "grid_box", {"guide_distance": True}),
            ("volbox_guided_bvh", "volbox", {"guide_distance": True, "accel": "bvh"})):
        imgs[name], counts[name] = drive(name, lambda: phase_reference_progressive(
            vs[scene_name], name, VOL_W, VOL_H, card, ref=ref[scene_name], **kw),
            route(prog_waves, bvh=kw.get("accel") == "bvh"))
    ref_cfg = RenderConfig(width=VOL_W, height=VOL_H, spp=VOL_RELMSE_REF_SPP, max_depth=DEPTH,
                           seed=99)
    ref_img, counts["volbox_reference"] = drive(
        "volbox_reference", lambda: render_scanned(vs["volbox"], ref_cfg),
        route(VOL_RELMSE_REF_SPP))
    emit({"phase": "volbox_relmse", "card": card, "spp": 16,
          "reference_spp": VOL_RELMSE_REF_SPP,
          "relmse_guide_distance_on": relmse(imgs["volbox_guided"], ref_img),
          "relmse_guide_distance_off": relmse(imgs["volbox_guided_no_distance"], ref_img)})
    # (c) bench.py's volumetric recipe
    bench, counts["volbox_bench"] = drive(
        "volbox_bench", lambda: phase_volume_bench(vs["volbox"], card),
        route(VOL_BENCH_WAVES + 1, depth=VOL_BENCH_DEPTH))
    # (e) each phase family but HG, render() in 4 groups of 4 spp
    cfg = RenderConfig(width=VOL_SMALL, height=VOL_SMALL, spp=VOL_PHASE_SPP // VOCAB_GROUPS,
                       max_depth=DEPTH)
    for kind in VOL_PHASES:
        name = f"volbox_{kind}"
        (_, _, rec), counts[name] = drive(
            name, lambda: render_groups(vs[name], name, cfg, card, ref[name]),
            route(VOL_PHASE_SPP))
        emit(rec)
    # (f) render_scanned is render (the reference's one-dispatch scan of
    # render's waves), and render repeats bit for bit (the film's splat
    # adds in an order fixed by the data); (g) the clamp, every sample's
    # radiance at or below it, the image at or below the unclamped one
    check(render_scanned is render, "render_scanned: not render")
    small = RenderConfig(width=VOL_SMALL, height=VOL_SMALL, spp=4, max_depth=DEPTH, seed=5)
    (img_r, img_s), counts["volbox_scanned"] = drive(
        "volbox_scanned", lambda: (render(vs["volbox"], small), render(vs["volbox"], small)),
        route(2 * small.spp))
    check(torch.equal(img_r, img_s), "render: the volbox image differs from call to call")
    real, peaks = rmod.render_wave, []

    def peaked(*a, **kw):
        out = real(*a, **kw)
        peaks.append(out[1].max())
        return out

    rmod.render_wave = peaked
    try:
        clamped, counts["volbox_clamp"] = drive(
            "volbox_clamp", lambda: render_scanned(
                vs["volbox"], small._replace(max_component_value=VOL_CLAMP)), route(small.spp))
        render_scanned(vs["volbox"], small)
        peaks_free = [float(x) for x in peaks[small.spp:]]
        peaks = [float(x) for x in peaks[:small.spp]]
    finally:
        rmod.render_wave = real
    check(max(peaks) <= VOL_CLAMP, f"clamp: a sample's radiance {max(peaks)} > {VOL_CLAMP}")
    check(max(peaks_free) > VOL_CLAMP, "clamp: no unclamped sample exceeds the clamp")
    check(bool((clamped <= img_r).all()), "clamp: the clamped image exceeds the unclamped one")
    emit({"phase": "volbox_scanned_clamp", "card": card, "resolution": f"{VOL_SMALL}x{VOL_SMALL}",
          "spp": small.spp, "render_repeats_bit_equal": True, "clamp": VOL_CLAMP,
          "max_sample_clamped": max(peaks), "max_sample_unclamped": max(peaks_free),
          "mean_clamped": float(clamped.mean()), "mean_unclamped": float(img_r.mean())})
    syncs = phase_volume_syncs(vs, cornell, card)
    torch.cuda.synchronize()
    return counts, bench, syncs

# ---------------------------------------------------------------------------
# the film's splat: the accumulation in an order fixed by the data against
# float atomics, on real waves
# ---------------------------------------------------------------------------

SPLAT_REPS = 5   # wall-clock repeats of a wave


def wall_ms(fn, reps=SPLAT_REPS):
    """The median wall time of fn() with the card drained before and after
    each call (host and card together, as a render pays them)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_splat_cost(scene, card):
    """The film's splat (film.splat, whose core.math.scatter_add_rows takes
    index_put_'s accumulation on the card: a stable sort by pixel, each
    pixel's rows added in row order) against the same splat through
    index_add_ (float atomics, in the order the threads arrive), on
    Cornell waves as render() makes them: a 256x256 wave through the fused
    route, the first 131072-pixel wave (one pixel_batch) of a 512x512
    render through the fused route, a 256x256 wavefront wave (the trivial
    guide, as render gives a scene the fused kernel cannot take) and the
    256x256 fused wave through the Gaussian filter (16 footprint rows a
    sample).  Each splat's card time (cuda_ms) and wall time (wall_ms)
    beside the wave's own wall time; the ordered splat repeats bit for
    bit."""
    import torch

    from mitsuba_path_guiding_torch.film import film as fmod
    from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
    from mitsuba_path_guiding_torch.guiding.trivial import trivial_grid
    from mitsuba_path_guiding_torch.integrators.render import PIXEL_BATCH, RenderConfig, render_wave
    from mitsuba_path_guiding_torch.models.bsdf import types_present

    ordered = fmod.scatter_add_rows

    def atomics(acc, idx, rows):
        return acc.index_add_(0, idx, rows)

    trivial = (make_guide_fn(0.0, types_present(scene.mats)), trivial_grid(DEVICE))
    waves = {"fused_256x256": (W, H, W * H, None, "box"),
             "fused_512x512_batch": (2 * W, 2 * H, PIXEL_BATCH, None, "box"),
             "wavefront_256x256": (W, H, W * H, trivial, "box"),
             "fused_256x256_gaussian": (W, H, W * H, None, "gaussian")}
    res = {}
    for name, (w, h, n, guide, filt) in waves.items():
        cfg = RenderConfig(width=w, height=h, spp=1, max_depth=DEPTH)
        pix = torch.arange(n, device=DEVICE)
        sidx = torch.zeros_like(pix)
        gkw = {} if guide is None else {"guide": guide[0], "guide_state": guide[1]}
        wave_ms = wall_ms(lambda: render_wave(scene, cfg, pix, sidx, **gkw))
        film_xy, L, _ = render_wave(scene, cfg, pix, sidx, **gkw)
        acc = fmod.new_film(w, h, device=DEVICE).rgb_weight

        def splat_once():
            return fmod.splat(acc.zero_(), film_xy, L, w, h, filt)

        rec = {"lanes": n, "filter": filt, "wave_ms": wave_ms}
        first = splat_once().clone()
        check(all(torch.equal(splat_once(), first) for _ in range(3)),
              f"splat {name}: the ordered accumulation differs from call to call")
        for label, fn in (("ordered", ordered), ("index_add", atomics)):
            fmod.scatter_add_rows = fn
            try:
                rec[f"{label}_ms"] = cuda_ms(splat_once)
                rec[f"{label}_wall_ms"] = wall_ms(splat_once)
            finally:
                fmod.scatter_add_rows = ordered
        rec["ordered_share_of_wave"] = rec["ordered_wall_ms"] / (wave_ms + rec["ordered_wall_ms"])
        res[name] = rec
    emit({"phase": "splat_cost", "card": card, "waves": res})
    return res


# ---------------------------------------------------------------------------
# textures, woven cloth and the denoiser
# ---------------------------------------------------------------------------

TEX_WHITE = [0.725, 0.71, 0.68]
TEX_SPP = 16                      # guided 4 spp x 4, or render() in 4 groups of 4
DENOISE_SPP = 16                  # the CLI's cornell with --denoise --aovs
DENOISE_REF_SPP = 256             # the unguided image the denoised one is read against
DENOISE_RTOL, DENOISE_ATOL = 1e-4, 1e-6
CLOTH_STD_BAR = 0.01              # the weave's structure (the JAX package's test_cloth.py)


def smooth_image(h, w, seed):
    """A smooth colour image in [0.1, 0.8] (seeded sinusoids), numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    fx, fy = rng.integers(1, 4, 3), rng.integers(1, 4, 3)
    ph = rng.uniform(0.0, 2.0 * np.pi, 3)
    img = 0.45 + 0.35 * np.sin(2.0 * np.pi * (fx * xx[..., None] + fy * yy[..., None]) + ph)
    return img.astype(np.float32)


def write_pfm(path, img):
    """A little-endian colour PFM (bottom row first), numpy only."""
    import numpy as np

    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n" + f"{w} {h}\n".encode() + b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def texture_descs(mod, directory):
    """The textures phase's scene descriptions, from ``mod``'s scenes and
    transforms (the port's here, the JAX package's in
    tools/texture_reference_means.py); the bitmap and the envmap read from
    files are written into ``directory`` first.
    - cornell_checker: the Cornell box with a checkerboard floor;
    - cornell_bitmap_scale: an inline image under ``scale`` on the back wall;
    - cornell_bitmap_pfm: a bitmap read from a .pfm on the back wall;
    - cornell_bump: a normal-mapped left wall and a bump-mapped right wall;
    - cornell_vcol_wire: a wireframe tall box and a curvature-coloured
      sphere (3968 triangles) for the short box;
    - cornell_cloth: an irawan back wall at 4 x 4 repeats;
    - cloth: the JAX package's test_cloth.py irawan plane at 4 x 4 repeats
      under a point light (a lone plane: no path finds light after its
      first bounce, so a guide has nothing to fit);
    - floor_cone: the JAX package's test_mipmap.py checker floor (32 x 32
      checks) under a constant sky, rendered with cone filtering;
    - envmap_file: a diffuse sphere on a floor under an envmap read from a
      .pfm."""
    import numpy as np

    os.makedirs(directory, exist_ok=True)
    descs = {}
    sc = mod.cornell_box()
    sc["shapes"][0]["bsdf"] = {"type": "diffuse", "texture": {
        "type": "checkerboard", "uscale": 4, "vscale": 4, "color0": TEX_WHITE,
        "color1": [0.15, 0.15, 0.15]}}
    descs["cornell_checker"] = sc
    sc = mod.cornell_box()
    sc["shapes"][2]["bsdf"] = {"type": "diffuse", "texture": {
        "type": "scale", "scale": [0.9, 0.8, 0.7],
        "texture": {"type": "bitmap", "image": smooth_image(64, 64, 1)}}}
    descs["cornell_bitmap_scale"] = sc
    wall = os.path.join(directory, "wall.pfm")
    write_pfm(wall, smooth_image(48, 80, 2))
    sc = mod.cornell_box()
    sc["shapes"][2]["bsdf"] = {"type": "diffuse", "texture": {"type": "bitmap", "filename": wall}}
    descs["cornell_bitmap_pfm"] = sc
    sc = mod.cornell_box()
    tilt = smooth_image(32, 32, 3) - 0.45  # normals within ~25 degrees of +z
    nmap = np.concatenate([tilt[..., :2], np.ones((32, 32, 1), np.float32)], axis=-1)
    nmap = nmap / np.linalg.norm(nmap, axis=-1, keepdims=True)
    sc["shapes"][3]["bsdf"] = {"type": "normalmap", "bsdf": sc["shapes"][3]["bsdf"],
                               "texture": {"type": "bitmap", "image": (nmap + 1.0) * 0.5}}
    sc["shapes"][4]["bsdf"] = {"type": "bumpmap", "scale": 0.02, "bsdf": sc["shapes"][4]["bsdf"],
                               "texture": {"type": "gridtexture", "uscale": 6, "vscale": 6,
                                           "line_width": 0.08}}
    descs["cornell_bump"] = sc
    sc = mod.cornell_box()
    sc["shapes"][5]["bsdf"] = {"type": "diffuse", "texture": {
        "type": "wireframe", "interior_color": TEX_WHITE, "edge_color": [0.05] * 3,
        "line_width": 0.06}}
    sc["shapes"][6] = {"type": "sphere", "center": [0.4, 0.3, -0.1], "radius": 0.3,
                       "bsdf": {"type": "diffuse", "texture": {"type": "curvature",
                                                               "curvature": "mean",
                                                               "scale": 0.3}}}
    descs["cornell_vcol_wire"] = sc
    sc = mod.cornell_box()
    sc["shapes"][2]["bsdf"] = {"type": "irawan", "repeatU": 4, "repeatV": 4}
    descs["cornell_cloth"] = sc
    descs["cloth"] = {
        "sensor": {"type": "orthographic", "to_world": mod.look_at([0, 0, -2], [0, 0, 0])},
        "shapes": [{"type": "rectangle", "bsdf": {"type": "irawan", "repeatU": 4,
                                                  "repeatV": 4}}],
        "emitters": [{"type": "point", "position": [1.0, 1.0, -2.0], "intensity": [6.0] * 3}]}
    descs["floor_cone"] = {
        "sensor": {"type": "perspective", "fov": 60.0,
                   "to_world": mod.look_at([0, 1.0, -3], [0, 0, 2])},
        "shapes": [{"type": "rectangle",
                    "to_world": np.array([[8, 0, 0, 0], [0, 0, 8, 0], [0, -8, 0, 0],
                                          [0, 0, 0, 1.0]]),
                    "bsdf": {"type": "diffuse", "texture": {"type": "checkerboard",
                                                            "uscale": 32, "vscale": 32}}}],
        "emitters": [{"type": "constant", "radiance": [1.0] * 3}]}
    sky = os.path.join(directory, "sky.pfm")
    yy = (np.arange(32)[:, None, None] + 0.5) / 32.0
    write_pfm(sky, (np.broadcast_to(1.5 - yy, (32, 64, 1)) * np.array([0.6, 0.8, 1.0])
                    + 0.5 * smooth_image(32, 64, 4)).astype(np.float32))
    descs["envmap_file"] = {
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": mod.look_at([0, 1.2, -4.0], [0, 0.4, 0])},
        "shapes": [{"type": "sphere", "center": [0, 0.6, 0], "radius": 0.6,
                    "bsdf": {"type": "diffuse", "reflectance": [0.6] * 3}},
                   {"type": "rectangle",
                    "to_world": np.array([[3, 0, 0, 0], [0, 0, 3, 0], [0, -3, 0, 0],
                                          [0, 0, 0, 1.0]]),
                    "bsdf": {"type": "diffuse", "reflectance": [0.5] * 3}}],
        "emitters": [{"type": "envmap", "filename": sky}]}
    return descs


# JAX package CPU means (unguided, NEE on, depth 5, 8 groups of 8 spp at
# 128x128, floor_cone at 256x256 with its cone filtering: mean, standard
# error) of texture_descs' scenes by tools/texture_reference_means.py; one
# run of 263.4 s, and cornell_cloth alone in 15.4 s
TEXTURE_REFERENCE = {
    "cornell_checker": (0.10810944996774197, 0.00020442452009166806),
    "cornell_bitmap_scale": (0.10504979733377695, 0.00020878874376788632),
    "cornell_bitmap_pfm": (0.10730080679059029, 0.00020812713602419062),
    "cornell_bump": (0.11337464489042759, 0.00020476509278906585),
    "cornell_vcol_wire": (0.11294289864599705, 0.00020235430483095184),
    "cornell_cloth": (0.10984980780631304, 0.0002030225247632445),
    "cloth": (0.13927694968879223, 2.3656341364291162e-05),
    "floor_cone": (0.5851100087165833, 2.1437744388925322e-05),
    "envmap_file": (0.7477866113185883, 0.00015865794279946698),
}


def texture_dir():
    """Where the textures phase writes its files: build/chip_smoke/ in the
    checkout."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")


def texture_scenes():
    from mitsuba_path_guiding_torch.scene import scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    return {name: build_scene(desc, device=DEVICE)
            for name, desc in texture_descs(scenes, texture_dir()).items()}


def phase_texture_kernel_checks(ts, card):
    """gather_rows_t on the curvature-coloured scene's (T, 9) vertex-colour
    table (3968 + 30 rows: the kernel's general path), bit-equal to its
    plain version on rows out of range too, then timed (gather_call) on
    the hit triangles of a camera wave; intersect_tiled bit-equal on the
    checkerboard Cornell box's camera wave."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas
    from mitsuba_path_guiding_torch.ops.gather import gather_rows_t, gather_rows_t_plain

    sc = ts["cornell_vcol_wire"]
    table = sc.geo.vcol
    check(table is not None and tuple(table.shape[1:]) == (9,) and table.shape[0] > 512,
          f"vertex-colour table {None if table is None else tuple(table.shape)}: expected "
          f"(T > 512, 9)")
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    idx = torch.randint(-3, table.shape[0] + 3, (W * H,), generator=gen, device=DEVICE)
    check(torch.equal(gather_rows_t(table, idx), gather_rows_t_plain(table, idx)),
          "gather_rows_t vertex-colour table, rows out of range: not bit-equal")
    o, d, _ = camera_rays(sc, 1, 0)
    hit = intersect_pallas(sc.geo, o, d)
    wave_call = gather_call(table, hit.prim.clamp_min(0).to(torch.int32))
    chk = ts["cornell_checker"]
    o, d, _ = camera_rays(chk, 1, 0)
    tmax = torch.full((o.shape[0],), 3.0e37, device=DEVICE)
    tiled = tiled_check(chk.geo, o, d, tmax, chk.geo.p0.shape[0], "checker Cornell camera")
    res = {"gather_rows_t_vcol_wave": wave_call, "intersect_tiled_checker_camera": tiled}
    emit({"phase": "texture_kernel_checks", "card": card, **res})
    return res


def phase_denoise(ref, card):
    """The CLI's cornell at 256x256, 16 spp with --denoise --aovs on the
    card (guided, 4 spp a progression; the feature buffers are 4 spp, once
    for the denoiser and once for the AOV files).  The denoiser's inputs
    and output are caught at film.neural_denoise.denoise_neural: the
    neural path ran (the weights loaded, the output not the a-trous
    base's), the card's output equals the port's CPU denoiser on the same
    buffers (rtol 1e-4, atol 1e-6), its relMSE against ``ref`` (a 256-spp
    unguided render) is below the noisy image's, and its time."""
    import numpy as np
    import torch

    from mitsuba_path_guiding_torch import render as cli
    from mitsuba_path_guiding_torch.film import denoise as dmod
    from mitsuba_path_guiding_torch.film import neural_denoise as nmod

    out = os.path.join(texture_dir(), "cornell_denoised.npy")
    real, caught = nmod.denoise_neural, {}

    def spy(color, albedo, normal, depth):
        img = real(color, albedo, normal, depth)
        caught.update(inputs=(color, albedo, normal, depth), out=img)
        return img

    nmod.denoise_neural = spy
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        rc = cli.main(["cornell", "-o", out, "-r", f"{W}x{H}", "-s", str(DENOISE_SPP),
                       "--denoise", "--aovs"] + ([] if DEVICE == "cuda" else ["--device", DEVICE]))
        torch.cuda.synchronize()
        dt = time.time() - t0
    finally:
        nmod.denoise_neural = real
    check(rc == 0 and "out" in caught, "CLI --denoise: no denoiser call")
    stem = os.path.splitext(out)[0]
    for name in ("albedo", "normal", "depth"):
        check(os.path.exists(f"{stem}_{name}.npy"), f"CLI --aovs: no {name} file")
    color, albedo, normal, depth = caught["inputs"]
    den = caught["out"]
    check(color.is_cuda and den.is_cuda, "denoiser: not on the card")
    check(nmod.load_net(color.device) is not None, "denoiser: the neural weights did not load")
    base = dmod.denoise_hdr(color, albedo, normal, depth)
    check(not torch.equal(den, base), "denoiser: the output is the a-trous base (no net)")
    written = np.load(out)
    check(np.array_equal(written, den.cpu().numpy()), "CLI: the written image is not the denoised")
    cpu = real(*(x.cpu() for x in caught["inputs"]))
    rel = ((den.cpu() - cpu).abs() / cpu.abs().clamp_min(DENOISE_ATOL / DENOISE_RTOL)).max()
    check(torch.allclose(den.cpu(), cpu, rtol=DENOISE_RTOL, atol=DENOISE_ATOL),
          f"denoiser: the card differs from the CPU (max rel {float(rel)})")
    ms = cuda_ms(lambda: real(color, albedo, normal, depth), reps=5)
    r_noisy, r_den = relmse(color, ref), relmse(den, ref)
    check(r_den < r_noisy, f"denoiser: relMSE {r_den} not below the noisy image's {r_noisy}")
    rec = {"phase": "cli_denoise", "card": card, "resolution": f"{W}x{H}", "spp": DENOISE_SPP,
           "cli_seconds": round(dt, 3), "neural": True, "denoise_ms": ms,
           "card_vs_cpu_max_rel": float(rel), "rtol": DENOISE_RTOL, "atol": DENOISE_ATOL,
           "reference_spp": DENOISE_REF_SPP, "relmse_noisy": r_noisy, "relmse_denoised": r_den,
           "relmse_ratio": r_den / r_noisy, "mean_noisy": float(color.mean()),
           "mean_denoised": float(den.mean())}
    emit(rec)
    return rec


def run_textures(ts, cornell, card):
    """The textures phase's renders, each between its own launch-count
    reset and read, held to the kernels it must launch: a textured bounce
    is two tiled queries and three gathers (shading, material and emitter
    rows; the texture's ids and tiling ride the material row's gather),
    with vertex colours a fourth on the (T, 9) colour table; the scenes
    with the 3968-triangle sphere gather from tables of more than 512 rows
    (the shading table, and the colour table).  No
    textured render launches trace_fused.  Returns their launch counts."""
    import torch

    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_torch.ops.fused_path import fused_supported

    def wavefront(n_waves, gathers=3, large=0):
        return {**NONE_LAUNCHED, "intersect_tiled": 2 * DEPTH * n_waves,
                "gather_rows_t": gathers * DEPTH * n_waves,
                "gather_rows_t_large": large * DEPTH * n_waves}

    counts = {}
    check(not fused_supported(ts["cornell_checker"]), "the fused gate takes a textured scene")
    for name in ("cornell_checker", "cornell_bitmap_scale", "cornell_bitmap_pfm", "cornell_bump",
                 "cornell_vcol_wire", "cornell_cloth", "envmap_file"):
        # the sphere's 3968 triangles make the shading table (and the
        # vertex-colour table) a large one
        vcol = name == "cornell_vcol_wire"
        large = 2 if vcol else 1 if name == "envmap_file" else 0
        _, counts[name] = drive(name, lambda: phase_reference_progressive(
            ts[name], name, W, H, card, ref=TEXTURE_REFERENCE[name]),
            wavefront(TEX_SPP, gathers=4 if vcol else 3, large=large))
    # unguided render() in 4 groups of 4 spp: the checkerboard box (the
    # fused gate must refuse it), the floor with its cone filtering, and
    # the cloth plane, as the JAX package's test renders it
    cfg = RenderConfig(width=W, height=H, spp=TEX_SPP // VOCAB_GROUPS, max_depth=DEPTH)
    for name, scene_name in (("cornell_checker_unguided", "cornell_checker"),
                             ("floor_cone", "floor_cone"), ("cloth", "cloth")):
        (img, _, rec), counts[name] = drive(
            name, lambda: render_groups(ts[scene_name], name, cfg, card,
                                        TEXTURE_REFERENCE[scene_name]), wavefront(TEX_SPP))
        emit(rec)
    std = float(img[W // 4:-W // 4, H // 4:-H // 4].mean(-1).std())
    check(std > CLOTH_STD_BAR, f"cloth: no weave structure (std {std})")
    emit({"phase": "cloth_weave", "card": card, "inner_std": std, "bar": CLOTH_STD_BAR})
    # the CLI's --denoise --aovs: 4 progressions of 4 waves, then 4 waves of
    # feature buffers for the denoiser and 4 for the AOV files
    ref = render(cornell, RenderConfig(width=W, height=H, spp=DENOISE_REF_SPP, max_depth=DEPTH,
                                       seed=99))
    _, counts["cli_denoise"] = drive("cli_denoise", lambda: phase_denoise(ref, card),
                                     wavefront(DENOISE_SPP + 8))
    torch.cuda.synchronize()
    return counts


# ---- the integrators phase (slice 9): the light-path and auxiliary
# integrators behind the CLI's -I

INTEGRATOR_RUNS = {                     # scene: (max_depth, integrators rendered)
    "cornell": (DEPTH, ("path", "direct", "ao", "ptracer", "bdpt", "vpl")),
    "cornell_point": (2, ("path", "bdpt")),   # a delta light's complete strategy set
    "veach": (DEPTH, ("path", "bdpt")),
}


def integrator_descs(mod):
    """The integrators phase's scenes from a scenes module (the port's or
    the JAX package's): the Cornell box, the JAX package's point-light
    Cornell box (tests/test_bdpt.py) and veach_mis."""
    point = mod.cornell_box()
    point["shapes"] = [s for s in point["shapes"] if not s.get("emitter")]
    point["emitters"] = [{"type": "point", "position": [0.0, 0.9, 0.0],
                          "intensity": [1.0, 0.9, 0.7]}]
    return {"cornell": mod.cornell_box(), "cornell_point": point, "veach": mod.veach_mis()}


INT_SPP = 16                # the CLI's default spp, in INT_GROUPS groups of 4 (seeds 0-3)
INT_GROUPS = 4
VPL_PATHS = 256             # render_vpl's default
INT_KERNEL_RAYS = 65536     # the first particles of render_ptracer's first wave
# The JAX package's cross-consistency bars against the forward path
# tracer of the same scene and depth (tests/test_bdpt.py,
# tests/test_ptracer.py, tests/test_vpl_erpt.py): (low, high) of the ratio.
INT_BARS = {"bdpt": (0.97, 1.03), "ptracer": (0.92, 1.08), "vpl": (0.85, 1.05)}
INT_SYNC_WAVES = 2
# Image means of the JAX package on the CPU (mean, standard error over 12
# groups of 4 spp at 64x64, seeds 1000-1011) by
# tools/integrator_reference_means.py ("intrefs"; 629.4 s on the CPU).
INTEGRATOR_REFERENCE = {
    "cornell/path": (0.11577501706779003, 0.0007155663628284205),
    "cornell/direct": (0.09270522681375344, 0.0006944721364549299),
    "cornell/ao": (0.2743988037109375, 0.0008144535000660717),
    "cornell/ptracer": (0.11469813498357932, 0.00010525860670066178),
    "cornell/bdpt": (0.11467706908782323, 8.126603248043725e-05),
    "cornell/vpl": (0.11339189670979977, 0.0007863927931929209),
    "cornell_point/path": (0.05931773688644171, 0.00024524105025458147),
    "cornell_point/bdpt": (0.05933357557902733, 9.510180111137946e-05),
    "veach/path": (0.3007487878203392, 0.018394745323190805),
    "veach/bdpt": (0.2845637947320938, 0.000800166569424295),
}


def integrator_scenes():
    from mitsuba_path_guiding_torch.scene import scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    return {k: build_scene(v, device=DEVICE) for k, v in integrator_descs(scenes).items()}


def light_wave_rays(scene, n=INT_KERNEL_RAYS):
    """The first n particles of render_ptracer's first wave on a scene:
    their emitter rays (as sample_ray draws them; dead lanes tmax -1) and
    the shadow rays of their first hits toward the camera (as trace_light
    connects them: offset origins, tmax dist (1 - 1e-3), -1 where the
    connection is masked off)."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.integrators.path import _offset_ray
    from mitsuba_path_guiding_torch.integrators.ptracer import (
        TAG_EMITTER_RAY,
        _decode_hit,
        live_tmax,
    )
    from mitsuba_path_guiding_torch.models.emitter import kinds_present, sample_ray
    from mitsuba_path_guiding_torch.models.sensor import connect_to_sensor

    pid = torch.arange(n, device=DEVICE)
    rkeys = rng.ray_keys(rng.base_key(0, device=DEVICE), pid, torch.zeros_like(pid))
    rs = sample_ray(scene.emitters, scene.aabb_min, scene.aabb_max,
                    rng.event_uniform(rkeys, TAG_EMITTER_RAY, 5),
                    kinds=kinds_present(scene.emitters))
    tmax = torch.where(rs.valid, 3.0e37, -1.0)
    hit = intersect_pallas(scene.geo, rs.o, rs.d, tmax)
    p, ng, _, _, _ = _decode_hit(scene.geo, hit, rs.o, rs.d)
    _, to_cam, dist, _, ok = connect_to_sensor(scene.sensor, W, H, p)
    return {"emitter": (rs.o, rs.d, tmax),
            "sensor": (_offset_ray(p, ng, to_cam), to_cam,
                       live_tmax(dist * (1.0 - 1e-3), rs.valid & hit.valid & ok))}


def vpl_fan_rays(scene):
    """The any-hit fan of render_vpl's first chunk on a scene at the CLI's
    defaults (256x256, depth 5, 256 VPL paths): the chunk's VPLs times the
    first camera hits, as shade_chunk queries them."""
    from mitsuba_path_guiding_torch.integrators import vpl
    from mitsuba_path_guiding_torch.integrators.path import route_dense_or_bvh
    from mitsuba_path_guiding_torch.integrators.ptracer import live_tmax
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    import torch

    cfg = RenderConfig(width=W, height=H, spp=1, max_depth=DEPTH)
    intersect, _ = route_dense_or_bvh(scene, "auto")
    vpls = vpl.generate_vpls(scene, VPL_PATHS, seed=cfg.seed + 1, max_depth=DEPTH - 2)
    n_vpl = vpls.pos.shape[0]
    c = vpl._chunk_size(n_vpl, W * H, 128)
    cam = vpl.camera_pass(scene, cfg, intersect, 0)
    d_min = 0.1 * float(torch.linalg.vector_norm(scene.aabb_max - scene.aabb_min))
    o, d, dist, _ = vpl.chunk_shadow_rays(cam, vpls.pos[:c], d_min * d_min)
    ok = cam.valid.repeat(c) & vpls.valid[:c].repeat_interleave(W * H)
    return o, d, live_tmax(dist * (1.0 - 2e-3), ok), c


def phase_integrator_kernel_checks(ic, card):
    """On the Cornell box: intersect_tiled against tiled_plain and the BVH
    kernel against bvh_plain, closest hit and any-hit, every output bit
    equal on every lane, on render_ptracer's first emitter rays and their
    sensor-connection shadow rays; gather_rows_t bit-equal on the shading
    rows of the emitter rays' hits (timed as gather_call times it); and
    intersect_tiled likewise on one VPL chunk's fan."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_cuda, bvh_plain

    sc = ic["cornell"]
    geo = sc.geo
    n_tri = geo.p0.shape[0]
    res = {}
    for label, (o, d, tmax) in light_wave_rays(sc).items():
        res[f"intersect_tiled_{label}"] = tiled_check(geo, o, d, tmax, n_tri, f"cornell {label}")
        for any_hit in (False, True):
            got = bvh_cuda(sc.bvh, o, d, tmax, any_hit)
            want = bvh_plain(sc.bvh, o, d, tmax, any_hit)
            torch.cuda.synchronize()
            differ = [int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, want)]
            check(not any(differ), f"bvh cornell {label} any_hit={any_hit}: lanes differing by "
                                   f"output {differ}")
            res[f"bvh_{label}_{'any' if any_hit else 'closest'}"] = {
                "rays": o.shape[0], "bit_equal": True,
                "hit_share": float((got[1] >= 0).float().mean())}
        if label == "emitter":
            prim = bvh_cuda(sc.bvh, o, d, tmax, False)[1]
            res["gather_rows_t_emitter_hits"] = gather_call(geo.shade_packed,
                                                            prim.clamp_min(0).to(torch.int32))
    o, d, tmax, c = vpl_fan_rays(sc)
    res["intersect_tiled_vpl_fan"] = {**tiled_check(geo, o, d, tmax, n_tri, "cornell vpl fan"),
                                      "vpls": c}
    emit({"phase": "integrator_kernel_checks", "card": card, **res})
    return res


def _large(table):
    from mitsuba_path_guiding_torch.ops.gather import SMALL_ROWS

    return int(table.shape[0] > SMALL_ROWS)


def integrator_launches(scene, integrator, depth, n_pix, spp, groups, accel="auto"):
    """The launches a render of ``groups`` calls of ``spp`` must give, and
    the lanes of its ray queries (None for the wavefront path tracer, whose
    rays render_counted counts).  A light-path bounce is a closest-hit and
    a shadow query and two gathers (shading and material rows); a BDPT
    camera bounce adds sample_direct's emitter row, and a wave (D - 1) D /
    2 interior connections, one shadow query each; a VPL chunk is one
    shadow query and two material gathers; the path tracer's bounce is two
    queries and three gathers.  Returns ({kernel: count}, lanes)."""
    from mitsuba_path_guiding_torch.integrators import vpl
    from mitsuba_path_guiding_torch.integrators.render import PIXEL_BATCH

    sh, ma, em = (_large(scene.geo.shade_packed), _large(scene.mats.packed),
                  _large(scene.emitters.packed))
    d = depth
    lanes = None
    if integrator == "ptracer":
        waves = -(-n_pix * spp // PIXEL_BATCH)
        q = g = (1 + 2 * d) * waves
        big = (em + (sh + ma) * d) * waves
        lanes = n_pix * spp * (1 + 2 * d)
    elif integrator == "bdpt":
        q1 = 1 + 4 * d + (d - 1) * d // 2
        q, g = q1 * spp, (1 + 5 * d) * spp
        big = (em * (1 + d) + (sh + ma) * 2 * d) * spp
        lanes = q1 * n_pix * spp
    elif integrator == "vpl":  # the VPLs are generated once a call
        gd = max(d - 2, 1)
        n_vpl = (gd + 1) * VPL_PATHS
        chunks = -(-n_vpl // vpl._chunk_size(n_vpl, n_pix, 128))
        q = gd + (1 + chunks) * spp
        g = 1 + 2 * gd + (1 + 2 * chunks) * spp
        big = em + (sh + ma) * gd + (sh + 2 * chunks * ma) * spp
        lanes = VPL_PATHS * gd + (1 + n_vpl) * n_pix * spp
    elif integrator == "ao":
        q, g, big, lanes = 2 * spp, spp, sh * spp, 2 * n_pix * spp
    else:  # the wavefront path tracer, in waves of at most PIXEL_BATCH pixels
        waves = -(-n_pix // PIXEL_BATCH) * spp
        q, g, big = 2 * d * waves, 3 * d * waves, (sh + ma + em) * d * waves
    bvh = accel == "bvh"
    return ({"intersect_tiled": 0 if bvh else q * groups, "intersect_bvh": q * groups if bvh else 0,
             "gather_rows_t": g * groups, "gather_rows_t_large": big * groups},
            None if lanes is None else lanes * groups)


def integrator_groups(scene, name, fn, cfg, card, ref_key, lanes=None):
    """fn(scene, cfg) in INT_GROUPS calls of cfg.spp, seeds 0 up: the
    mean and standard error of their image means, held within max(3%, 4
    sqrt(se_ref^2 + se^2)) of the JAX package's mean
    (INTEGRATOR_REFERENCE[ref_key]).  Mrays/s counts the lanes of every
    ray query (``lanes``), or, where fn renders through render() (lanes
    None), 2 x the path segments.  Returns (first group's image, mean,
    record)."""
    import torch

    means, first, secs, segs = [], None, 0.0, 0
    for g in range(INT_GROUPS):
        c = cfg._replace(seed=g)
        if lanes is None:
            img, dt, sg = render_counted(scene, c, fn)
            segs += sg
        else:
            torch.cuda.synchronize()
            t0 = time.time()
            img = fn(scene, c)
            torch.cuda.synchronize()
            dt = time.time() - t0
        check(bool(torch.isfinite(img).all()), f"{name}: image not finite")
        means.append(float(img.mean()))
        first = img if first is None else first
        secs += dt
    mean = statistics.fmean(means)
    se = statistics.stdev(means) / len(means) ** 0.5
    ref = INTEGRATOR_REFERENCE[ref_key]
    check(mean > 0.0, f"{name}: image is black")
    tol = max(MEAN_TOL, 4.0 * (ref[1] ** 2 + se ** 2) ** 0.5 / ref[0])
    rel = abs(mean - ref[0]) / ref[0]
    check(rel < tol, f"{name}: mean {mean} vs reference {ref[0]} (tol {tol})")
    rays = 2 * segs if lanes is None else lanes
    rec = {"phase": name, "card": card, "resolution": f"{cfg.width}x{cfg.height}",
           "spp": cfg.spp * INT_GROUPS, "max_depth": cfg.max_depth, "accel": cfg.accel,
           "seconds": round(secs, 3), "mean": mean, "se": se, "group_means": means,
           "mrays_per_s": rays / secs / 1e6, "rays": rays,
           "reference_mean": ref[0], "reference_se": ref[1], "rel_err": rel, "rel_tol": tol,
           "reference": "intrefs: tools/integrator_reference_means.py"}
    return first, mean, rec


def light_path_syncs(scene):
    """Host syncs a wave (syncs_per_wave) of trace_light (131072
    particles, render_ptracer's wave) and of trace_bdpt (the 256x256
    image) on the Cornell box at depth 5, each with its light splat."""
    import torch

    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.integrators import bdpt, ptracer
    from mitsuba_path_guiding_torch.integrators.render import PIXEL_BATCH
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    kw = dict(em_kinds=kinds_present(scene.emitters), mat_types=types_present(scene.mats),
              max_depth=DEPTH)
    key = rng.base_key(0, device=DEVICE)
    pid = torch.arange(PIXEL_BATCH, device=DEVICE)
    pix = torch.arange(W * H, device=DEVICE)
    lkeys = rng.ray_keys(key, pid, torch.zeros_like(pid))
    pkeys = rng.ray_keys(key, pix, torch.zeros_like(pix))
    acc = torch.zeros((W * H, 3), device=DEVICE)

    def light():
        ptracer.splat_light(acc, ptracer.trace_light(scene, lkeys, W, H, **kw), W, H)

    def bidir():
        ptracer.splat_light(acc, bdpt.trace_bdpt(scene, pkeys, pix, W, H, **kw)[1], W, H)

    out = {}
    for name, fn in (("ptracer", light), ("bdpt", bidir)):
        n, sites = syncs_per_wave(fn, INT_SYNC_WAVES)
        out[name] = {"syncs_per_wave": n, "by_source_line": sites}
    return out


def run_integrators(ic, card):
    """The integrators phase's renders, each between its own launch-count
    reset and read, held to the launches integrator_launches gives: on the
    Cornell box at the CLI's defaults (256x256, 16 spp, depth 5) the
    forward path tracer and direct (render(), trace_fused), ao, ptracer,
    bdpt, vpl and bdpt through the BVH; the point-light Cornell box at
    depth 2 (path and bdpt); veach_mis at 512x512 (path and bdpt);
    then the CLI's cornell -I bdpt.  Each mean is held to the JAX
    package's, bdpt, ptracer and vpl to the cross-consistency bars against
    the path tracer, direct to render() at depth 1, ptracer and bdpt to a
    repeat of their first group bit for bit.  Returns their launch counts
    by route."""
    import torch

    from mitsuba_path_guiding_torch import render as cli
    from mitsuba_path_guiding_torch.film.film import read_pfm
    from mitsuba_path_guiding_torch.integrators import aux_integrators, bdpt, ptracer, vpl
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render

    funcs = {"path": render, "direct": aux_integrators.render_direct,
             "ao": aux_integrators.render_ao, "ptracer": ptracer.render_ptracer,
             "bdpt": bdpt.render_bdpt, "vpl": vpl.render_vpl}
    counts, means, firsts = {}, {}, {}
    spp = INT_SPP // INT_GROUPS

    def run(scene_name, integrator, width=W, accel="auto"):
        sc = ic[scene_name]
        depth = INTEGRATOR_RUNS[scene_name][0]
        cfg = RenderConfig(width=width, height=width, spp=spp, max_depth=depth, accel=accel)
        route = f"int_{scene_name}_{integrator}" + ("_bvh" if accel == "bvh" else "")
        if scene_name == "cornell" and integrator in ("path", "direct"):
            # unguided render() takes trace_fused on Cornell, one launch a wave
            expect, lanes = {"trace_fused": spp * INT_GROUPS}, None
        else:
            expect, lanes = integrator_launches(sc, integrator, depth, width * width, spp,
                                                INT_GROUPS, accel)
        (first, mean, rec), counts[route] = drive(
            route, lambda: integrator_groups(sc, route, funcs[integrator], cfg, card,
                                             f"{scene_name}/{integrator}", lanes),
            {**NONE_LAUNCHED, **expect})
        emit(rec)
        means[route], firsts[route] = mean, (first, cfg)

    for integrator in ("path", "direct", "ao", "ptracer", "bdpt", "vpl"):
        run("cornell", integrator)
    run("cornell", "bdpt", accel="bvh")
    run("cornell_point", "path")
    run("cornell_point", "bdpt")
    run("veach", "path", width=VEACH_W)
    run("veach", "bdpt", width=VEACH_W)

    # direct is render() at depth 1; ptracer and bdpt repeat bit for bit
    first, cfg = firsts["int_cornell_direct"]
    check(torch.equal(first, render(ic["cornell"], cfg._replace(max_depth=1))),
          "direct: not render() at depth 1")
    repeats = {}
    for route, fn in (("int_cornell_ptracer", ptracer.render_ptracer),
                      ("int_cornell_bdpt", bdpt.render_bdpt),
                      ("int_cornell_bdpt_bvh", bdpt.render_bdpt)):
        first, cfg = firsts[route]
        repeats[route] = bool(torch.equal(first, fn(ic["cornell"], cfg)))
        check(repeats[route], f"{route}: a second call differs")

    ratios = {}
    for scene_name, integrator in (("cornell", "bdpt"), ("cornell", "ptracer"),
                                   ("cornell", "vpl"), ("cornell_point", "bdpt"),
                                   ("veach", "bdpt")):
        r = means[f"int_{scene_name}_{integrator}"] / means[f"int_{scene_name}_path"]
        ratios[f"{scene_name}/{integrator}"] = r
        if scene_name != "veach":
            lo, hi = INT_BARS[integrator]
            check(lo < r < hi, f"{scene_name} {integrator}/path = {r}, bar ({lo}, {hi})")
    r = means["int_cornell_bdpt_bvh"] / means["int_cornell_bdpt"]
    check(abs(r - 1.0) < 0.01, f"bdpt through the BVH: {r} of the tiled route's mean")
    ratios["cornell/bdpt_bvh_over_tiled"] = r

    # the CLI's cornell -I bdpt at its defaults (256x256, 16 spp, depth 5)
    out = os.path.join(texture_dir(), "cli_bdpt.pfm")
    os.makedirs(texture_dir(), exist_ok=True)
    sc = ic["cornell"]
    expect, _ = integrator_launches(sc, "bdpt", DEPTH, W * H, INT_SPP, 1)

    def cli_run():
        torch.cuda.synchronize()
        t0 = time.time()
        cli.main(["cornell", "-I", "bdpt", "-o", out])
        return time.time() - t0

    secs, counts["int_cli_bdpt"] = drive("int_cli_bdpt", cli_run,
                                        {**NONE_LAUNCHED, **expect, "trace_fused": 0})
    img = read_pfm(out)
    ref = INTEGRATOR_REFERENCE["cornell/bdpt"]
    rel = abs(float(img.mean()) - ref[0]) / ref[0]
    check(bool((img == img).all()) and img.mean() > 0.0, "cli bdpt: image not finite or black")
    check(rel < MEAN_TOL, f"cli bdpt: mean {img.mean()} vs reference {ref[0]}")
    emit({"phase": "int_cli_bdpt", "card": card, "argv": "cornell -I bdpt",
          "seconds_with_scene_build": round(secs, 3), "mean": float(img.mean()),
          "reference_mean": ref[0], "rel_err": rel})
    emit({"phase": "integrator_consistency", "card": card, "ratios_to_path": ratios,
          "bars": INT_BARS, "repeat_bit_equal": repeats,
          "host_syncs": light_path_syncs(ic["cornell"])})
    return counts


# ---- the chains phase (slice 10): the Markov-chain and photon-map
# integrators behind the CLI's -I


def chain_descs(mod):
    """The chains phase's scenes from a scenes module (the port's or the
    JAX package's) and the transforms beside it:
    - cornell: the Cornell box;
    - big_light_box: the Cornell box with a 0.6-scaled area light
      (tests/test_mlt.py), where unidirectional paths find the light often;
    - caustic_box: big_light_box with a mirror slab, lighting the floor
      through E-D-S-L paths (tests/test_mlt.py);
    - floor_point: a diffuse floor under a point light (tests/test_sppm.py);
    - glossy_floor: the Cornell box with a rough-conductor floor of alpha
      0.06, below the direction bins' resolution: SPPM's per-photon route
      (tests/test_sppm.py);
    - medium_box: a black box of a homogeneous medium around a point light
      (tests/test_volphoton.py)."""
    import importlib

    tf = importlib.import_module(mod.__name__.rsplit(".", 1)[0] + ".transforms")
    big = mod.cornell_box(light_scale=1.0)
    for shape in big["shapes"]:
        if "emitter" in shape:
            shape["to_world"] = (tf.translate(0, 1.995, 0) @ tf.rotate([1, 0, 0], 90)
                                 @ tf.scale(0.6))
    caustic = mod.cornell_box(light_scale=1.0)
    caustic["shapes"] = [dict(sh) for sh in big["shapes"]] + [{
        "type": "rectangle",
        "to_world": tf.translate(-0.55, 0.7, 0.2) @ tf.rotate([0, 1, 0], 55) @ tf.scale(0.35),
        "bsdf": {"type": "conductor", "material": "none"}}]
    floor = {
        "sensor": {"type": "perspective", "fov": 45.0,
                   "to_world": tf.look_at([0, 2, -4], [0, 0, 0])},
        "shapes": [{"type": "rectangle", "to_world": tf.rotate([1, 0, 0], -90) @ tf.scale(2.0),
                    "bsdf": {"type": "diffuse", "reflectance": [0.6] * 3}}],
        "emitters": [{"type": "point", "position": [0, 2.5, 0], "intensity": [8.0] * 3}]}
    glossy = mod.cornell_box()
    glossy["shapes"][0]["bsdf"] = {"type": "roughconductor", "alpha": 0.06, "material": "none",
                                   "specular_reflectance": [0.9, 0.9, 0.9]}
    black = {"type": "diffuse", "reflectance": [0.0, 0.0, 0.0]}
    walls = [((0, 0, -2), tf.rotate([1, 0, 0], 0)), ((0, 0, 2), tf.rotate([0, 1, 0], 180)),
             ((-2, 0, 0), tf.rotate([0, 1, 0], 90)), ((2, 0, 0), tf.rotate([0, 1, 0], -90)),
             ((0, -2, 0), tf.rotate([1, 0, 0], -90)), ((0, 2, 0), tf.rotate([1, 0, 0], 90))]
    medium = {
        "shapes": [{"type": "rectangle", "to_world": tf.translate(*p) @ r @ tf.scale(2.0),
                    "bsdf": black} for p, r in walls],
        "emitters": [{"type": "point", "position": [0.0, 0.0, 0.0],
                      "intensity": [4.0, 4.0, 4.0]}],
        "medium": {"sigma_s": [0.6] * 3, "sigma_a": [0.1] * 3, "g": 0.0},
        "sensor": {"type": "perspective", "fov": 60.0,
                   "to_world": tf.look_at([0, 0, -1.9], [0, 0, 0])}}
    return {"cornell": mod.cornell_box(), "big_light_box": big, "caustic_box": caustic,
            "floor_point": floor, "glossy_floor": glossy, "medium_box": medium}


# The JAX package's tests of the chain and photon integrators
# (tests/test_mlt.py, test_ptracer.py, test_vpl_erpt.py, test_sppm.py,
# test_photonmapper.py) as runs of chain_descs' scenes: name -> (scene,
# integrator, resolution, spp (mutations a pixel for the chains, camera
# samples for the photon mapper), max_depth, the test's seed, the
# integrator's keyword arguments).
CHAIN_RUNS = {
    "mlt_big": ("big_light_box", "mlt", 16, 768, 4, 5, {"n_chains": 4096}),
    "mlt_caustic": ("caustic_box", "mlt", 16, 768, 4, 7, {"n_chains": 4096}),
    "mlt_caustic_512": ("caustic_box", "mlt", 16, 512, 4, 3, {"n_chains": 4096}),
    "pssmlt_caustic_512": ("caustic_box", "pssmlt", 16, 512, 4, 3, {"n_chains": 4096}),
    "pssmlt_cornell": ("cornell", "pssmlt", 24, 96, 4, 1,
                       {"n_chains": 4096, "bootstrap_factor": 8}),
    "erpt_cornell": ("cornell", "erpt", 16, 24, 4, 11, {"chain_length": 12}),
    "sppm_floor": ("floor_point", "sppm", 24, 1, 2, 1,
                   {"n_iterations": 5, "photons_per_iter": 32768}),
    "sppm_cornell": ("cornell", "sppm", 24, 1, 5, 0,
                     {"n_iterations": 6, "photons_per_iter": 32768}),
    "sppm_glossy": ("glossy_floor", "sppm", 24, 1, 4, 0,
                    {"n_iterations": 8, "photons_per_iter": 32768}),
    "pm_cornell": ("cornell", "photonmapper", 16, 24, 4, 5, {"n_photons": 65536}),
}
# runs without a JAX CPU mean: the narrow-glossy gather unrolls 256
# per-photon BSDF evaluations, and its compile alone takes minutes
CHAIN_NO_REFERENCE = ("sppm_glossy",)


CHAIN_GROUPS = 4        # seeds of each CHAIN_RUNS run on the card: the test's and the next three
CHAIN_GROUPS_OF = {"erpt_cornell": 2}   # but two of ERPT's (1248 traces of 256 lanes a seed)
CHAIN_CLI = ("pssmlt", "mlt", "erpt", "sppm", "photonmapper")
# The JAX tests' bars against the path tracer of the same scene: run ->
# (the path tracer's resolution, spp, max_depth, seed, use_nee; the bar):
# ("rel", r): means within r; ("rel_corr", (r, c)): and the pixels'
# correlation above c; ("ratio", (lo, hi)): the ratio of the means.
CHAIN_BARS = {
    "mlt_big": ((16, 512, 4, 0, False), ("rel", 0.12)),
    "mlt_caustic": ((16, 512, 4, 2, False), ("rel", 0.15)),
    "pssmlt_cornell": ((24, 96, 4, 0, True), ("rel_corr", (0.12, 0.9))),
    "erpt_cornell": ((16, 256, 4, 3, True), ("rel", 0.06)),
    "sppm_floor": ((24, 64, 2, 1, True), ("rel", 0.08)),
    "sppm_cornell": ((24, 96, 5, 0, True), ("rel_corr", (0.12, 0.95))),
    "sppm_glossy": ((24, 192, 4, 0, True), ("rel_corr", (0.2, 0.9))),
    "pm_cornell": ((16, 256, 4, 3, True), ("ratio", (0.80, 1.20))),
}
# path space beats primary-sample space at 512 mutations a pixel on the
# caustic box: squared error against this path-traced image
CHAIN_PSS_REFERENCE = (16, 2048, 4, 11, False)
# the CLI's defaults on the Cornell box, each image's ratio to the path
# tracer's at the same defaults, held to the JAX tests' bars
CHAIN_CLI_BARS = {"pssmlt": (0.88, 1.12), "mlt": (0.88, 1.12), "erpt": (0.94, 1.06),
                  "sppm": (0.88, 1.12), "photonmapper": (0.80, 1.20)}
# tests/test_volphoton.py: 6 waves of 65536 volume photons at depth 6, a
# 0.12 gather radius, 4096 camera rays with 16 beam points each, against
# trace_vol at 24 spp; |ratio - 1| < 0.15
VOLPHOTON = {"photons": 65536, "waves": 6, "depth": 6, "r": 0.12, "rays": 4096, "taps": 16,
             "spp": 24, "bar": 0.15}
CHAIN_SYNC_CALLS = 2
# Image means of the JAX package on the CPU, one render a run at the
# test's seed, by tools/chain_reference_means.py ("chainrefs"; 284.6 s
# on the CPU).
CHAIN_REFERENCE = {
    "mlt_big": 0.6844627261161804,
    "mlt_caustic": 0.6569505929946899,
    "mlt_caustic_512": 0.6602808833122253,
    "pssmlt_caustic_512": 0.6612117290496826,
    "pssmlt_cornell": 0.11029162257909775,
    "erpt_cornell": 0.11289000511169434,
    "sppm_floor": 0.08578630536794662,
    "sppm_cornell": 0.1148117259144783,
    "pm_cornell": 0.11667612195014954,
}


def chain_scenes():
    from mitsuba_path_guiding_torch.scene import scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    return {k: build_scene(v, device=DEVICE) for k, v in chain_descs(scenes).items()}


def chain_funcs():
    from mitsuba_path_guiding_torch.integrators import erpt, mlt, photonmapper, pssmlt, sppm

    return {"mlt": mlt.render_mlt, "pssmlt": pssmlt.render_pssmlt, "erpt": erpt.render_erpt,
            "sppm": sppm.render_sppm, "photonmapper": photonmapper.render_photonmapper}


def chain_launches(integrator, depth, res, spp, kw, bvh=False):
    """The launches of one render: a trace bounce (PSSMLT, ERPT) is two
    queries and three gathers; an MLT path bounce a query and two gathers
    (the last one gather), a perturbation V + 1 queries and 4V + 3
    gathers (2V - 1 of them its re-evaluation's), a large step a traced
    path;
    an SPPM pass 2D queries and 4D + 2 gathers; the photon mapper's photon
    wave D queries and 2D + 1 gathers, a camera sample D + 2 queries and
    2D + 3 gathers."""
    d = depth
    if integrator in ("pssmlt", "erpt"):
        if integrator == "pssmlt":
            traces = 1 + max(res * res * spp // kw.get("n_chains", 8192), 1)
        else:
            traces = spp * (1 + kw.get("chain_length", 16))
        q, g = 2 * d * traces, 3 * d * traces
    elif integrator == "mlt":
        steps = max(res * res * spp // kw.get("n_chains", 4096), 1)
        large = (steps + 3) // 4
        pert = steps - large
        q = d * (1 + large) + (d + 1) * pert
        g = (2 * d - 1) * (1 + large) + (4 * d + 3) * pert
    elif integrator == "sppm":
        it = kw.get("n_iterations", 8)
        q, g = 2 * d * it, (4 * d + 2) * it
    else:  # photonmapper
        s = max(spp, 1)
        q, g = d + (d + 2) * s, 1 + 2 * d + (2 * d + 3) * s
    return {"intersect_tiled": 0 if bvh else q, "intersect_bvh": q if bvh else 0,
            "gather_rows_t": g, "gather_rows_t_large": 0}


class QueryLanes:
    """Counts the lanes of every intersect_tiled and BVH launch while on
    (all lanes, and live lanes: tmax >= 0, summed on the card)."""

    def __init__(self):
        from mitsuba_path_guiding_torch.ops import intersect_bvh, intersect_tiled

        self.mods = ((intersect_tiled, "intersect_tiled_cuda"), (intersect_bvh, "bvh_cuda"))
        self.lanes, self.live = 0, []

    def __enter__(self):
        self.saved = [getattr(m, a) for m, a in self.mods]
        for (m, a), real in zip(self.mods, self.saved):
            def counted(*args, _real=real, **kw):
                o, tmax = args[1], args[3]
                self.lanes += o.shape[0]
                self.live.append((tmax >= 0).sum())
                return _real(*args, **kw)
            setattr(m, a, counted)
        return self

    def __exit__(self, *exc):
        for (m, a), real in zip(self.mods, self.saved):
            setattr(m, a, real)

    def live_lanes(self):
        return int(sum(int(x) for x in self.live))


def timed_render(fn):
    """(fn()'s result, seconds, query lanes, live query lanes)."""
    import torch

    with QueryLanes() as ql:
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
    return out, dt, ql.lanes, ql.live_lanes()


def wide_path_render(scene, res, spp, depth, seed, use_nee, lanes=1 << 17):
    """The path tracer's image of render() (the same samples), in waves of
    about ``lanes`` lanes: spp planes of the image a wave."""
    import torch

    from mitsuba_path_guiding_torch.film.film import Film, develop, new_film, splat
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render_wave

    cfg = RenderConfig(width=res, height=res, spp=spp, max_depth=depth, seed=seed,
                       use_nee=use_nee)
    n_pix = res * res
    k = max(1, lanes // n_pix)
    rgbw = new_film(res, res, device=DEVICE).rgb_weight
    for s0 in range(0, spp, k):
        m = min(k, spp - s0)
        pix = torch.arange(n_pix, device=DEVICE).repeat(m)
        sidx = torch.arange(s0, s0 + m, device=DEVICE).repeat_interleave(n_pix)
        film_xy, L, _ = render_wave(scene, cfg, pix, sidx)
        rgbw = splat(rgbw, film_xy, L, res, res)
    return develop(Film(rgb_weight=rgbw, width=res, height=res))


def record_queries(module, fn):
    """fn() with ``module``'s route_dense_or_bvh wrapped: returns (fn()'s
    result, the (o, d, tmax, any_hit) of every query, in order)."""
    from mitsuba_path_guiding_torch.integrators.path import route_dense_or_bvh

    calls = []

    def recording(scene, accel="auto", use_bvh=False):
        intersect, occluded = route_dense_or_bvh(scene, accel, use_bvh)

        def rec_intersect(o, d, tmax):
            calls.append((o, d, tmax, False))
            return intersect(o, d, tmax)

        def rec_occluded(o, d, tmax):
            calls.append((o, d, tmax, True))
            return occluded(o, d, tmax)
        return rec_intersect, rec_occluded

    real = module.route_dense_or_bvh
    module.route_dense_or_bvh = recording
    try:
        return fn(), calls
    finally:
        module.route_dense_or_bvh = real


def bvh_check(bvh, o, d, tmax, label):
    """The BVH kernel against bvh_plain, closest hit and any-hit: every
    output bit equal on every lane."""
    import torch

    from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_cuda, bvh_plain

    out = {}
    for any_hit in (False, True):
        got = bvh_cuda(bvh, o, d, tmax, any_hit)
        want = bvh_plain(bvh, o, d, tmax, any_hit)
        torch.cuda.synchronize()
        differ = [int((_bits(a) != _bits(b)).sum()) for a, b in zip(got, want)]
        check(not any(differ), f"bvh {label} any_hit={any_hit}: lanes differing by output "
                               f"{differ}")
        out["any" if any_hit else "closest"] = {
            "rays": o.shape[0], "bit_equal": True,
            "hit_share": float((got[1] >= 0).float().mean())}
    return out


def chain_kernel_rays(cs):
    """The three ray sets of the chains phase's kernel checks and the MLT
    bootstrap's hits: an SPPM photon pass's first bounce rays on the
    Cornell box (131072 photons; origins on the walls, dead lanes tmax
    -1), the reconnection shadow rays of one perturbation of the caustic
    box's 4096 MLT chains, and a volume photon pass's surface rays in the
    medium box (65536 photons, depth 6)."""
    import torch

    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.integrators import mlt, sppm, volphoton
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    sc = cs["cornell"]
    ids = torch.arange(1 << 17, dtype=torch.int32, device=DEVICE) + (1 << 24)
    rk = rng.ray_keys(rng.base_key(0, device=DEVICE), ids, torch.zeros_like(ids))
    _, calls = record_queries(sppm, lambda: sppm.photon_pass(
        sc, rk, max_depth=DEPTH, em_kinds=kinds_present(sc.emitters)))
    photon_bounce = calls[1][:3]

    cb = cs["caustic_box"]
    cfg = RenderConfig(width=W, height=H, spp=1, max_depth=4)
    st = mlt.scene_statics(cb, cfg)
    shadow, hits = [], []

    def rec_occluded(o, d, tmax):
        shadow.append((o, d, tmax))
        return st.occluded(o, d, tmax)

    def rec_intersect(o, d, tmax):
        hit = st.intersect(o, d, tmax)
        hits.append(hit.prim)
        return hit

    key = rng.base_key(1, device=DEVICE)
    boot = mlt._trace_path(cb, cfg, rng.uniform_shape(key, (2 + 3 * 4, 4096)),
                           st._replace(intersect=rec_intersect))
    mlt._perturb(cb, cfg, st._replace(occluded=rec_occluded), boot,
                 rng.uniform_shape(rng.fold_in(key, 1), (9, 4096)))

    mb = cs["medium_box"]
    pk = rng.ray_keys(rng.base_key(5, device=DEVICE), torch.zeros(1 << 16, dtype=torch.int64,
                                                                   device=DEVICE),
                      torch.arange(1 << 16, device=DEVICE))
    _, vcalls = record_queries(volphoton, lambda: volphoton.volume_photon_pass(
        mb, pk, max_depth=VOLPHOTON["depth"], em_kinds=kinds_present(mb.emitters)))
    return {"sppm_photon_bounce": (sc, photon_bounce),
            "mlt_reconnection": (cb, shadow[0]),
            "volume_photon_surface": (mb, vcalls[1][:3])}, (cb, hits)


def phase_chain_kernel_checks(cs, card):
    """intersect_tiled against tiled_plain and the BVH kernel against
    bvh_plain, closest hit and any-hit, every output bit equal on every
    lane, on chain_kernel_rays' three sets; gather_rows_t bit-equal on
    the shading rows of the MLT bootstrap's first hits (timed as
    gather_call times it)."""
    import torch

    sets, (cb, hits) = chain_kernel_rays(cs)
    res = {}
    for label, (sc, (o, d, tmax)) in sets.items():
        n_tri = sc.geo.p0.shape[0]
        res[f"intersect_tiled_{label}"] = tiled_check(sc.geo, o, d, tmax, n_tri, label)
        res[f"bvh_{label}"] = bvh_check(sc.bvh, o, d, tmax, label)
    res["gather_rows_t_mlt_bootstrap_hits"] = gather_call(
        cb.geo.shade_packed, hits[0].clamp_min(0).to(torch.int32))
    emit({"phase": "chain_kernel_checks", "card": card, **res})
    return res


def bar_check(name, img, ref, bar):
    """A JAX test's bar (CHAIN_BARS) on img against the path tracer's ref;
    returns the numbers read."""
    import numpy as np

    a, b = img.cpu().numpy(), ref.cpu().numpy()
    kind, val = bar
    ratio = float(a.mean() / b.mean())
    out = {"ratio_to_path": ratio}
    if kind in ("rel", "rel_corr"):
        r = val if kind == "rel" else val[0]
        check(abs(ratio - 1.0) < r, f"{name}: mean ratio to the path tracer {ratio}, bar {r}")
    if kind == "rel_corr":
        corr = float(np.corrcoef(b.mean(-1).ravel(), a.mean(-1).ravel())[0, 1])
        out["corr"] = corr
        check(corr > val[1], f"{name}: correlation with the path tracer {corr}, bar {val[1]}")
    if kind == "ratio":
        check(val[0] < ratio < val[1], f"{name}: ratio to the path tracer {ratio}, bar {val}")
    if name == "mlt_big":
        k = b.shape[0] // 4
        rb = b.reshape(4, k, 4, k, 3).mean(axis=(1, 3))
        mb = a.reshape(4, k, 4, k, 3).mean(axis=(1, 3))
        out["block_rel"] = float((np.abs(mb - rb) / np.maximum(rb, 5e-2)).mean())
        check(out["block_rel"] < 0.35, f"mlt_big: 4x4-block error {out['block_rel']}")
    return out


def run_chain_tests(cs, card):
    """Each CHAIN_RUNS run at CHAIN_GROUPS seeds (CHAIN_GROUPS_OF's
    count for its runs; the JAX test's seed first),
    between one launch-count reset and read, held to chain_launches; the
    first seed's image to the JAX test's bar against the path tracer
    (CHAIN_BARS); the seeds' mean to the JAX package's CPU mean of the
    test's seed (CHAIN_REFERENCE) within max(3%, 4 sd sqrt(1 + 1 /
    groups)), sd the seeds' spread; path space beating PSS on the caustic
    box; mlt_big's first seed through the BVH within 1% of the tiled
    route's mean.  Returns the launch counts by run."""
    import torch

    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    funcs = chain_funcs()
    counts, firsts = {}, {}
    for run, (name, integrator, res, spp, depth, seed, kw) in CHAIN_RUNS.items():
        sc = cs[name]
        n_groups = CHAIN_GROUPS_OF.get(run, CHAIN_GROUPS)

        def groups():
            out = []
            for g in range(n_groups):
                cfg = RenderConfig(width=res, height=res, spp=spp, max_depth=depth, seed=seed + g)
                out.append(timed_render(lambda: funcs[integrator](sc, cfg, **kw)))
            return out

        one = chain_launches(integrator, depth, res, spp, kw)
        renders, counts[f"chain_{run}"] = drive(
            f"chain_{run}", groups, {**NONE_LAUNCHED, **{k: v * n_groups for k, v in one.items()}})
        imgs = [r[0] for r in renders]
        for img in imgs:
            check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
                  f"{run}: image not finite or black")
        means = [float(img.mean()) for img in imgs]
        mean = statistics.fmean(means)
        sd = statistics.stdev(means)
        secs = sum(r[1] for r in renders)
        rec = {"phase": f"chain_{run}", "card": card, "scene": name, "integrator": integrator,
               "resolution": f"{res}x{res}", "spp": spp, "max_depth": depth,
               "seeds": [seed + g for g in range(n_groups)], "kwargs": kw,
               "group_means": means, "mean": mean, "sd": sd, "seconds": round(secs, 3),
               "mrays_per_s": sum(r[2] for r in renders) / secs / 1e6}
        if run in CHAIN_REFERENCE:
            ref = CHAIN_REFERENCE[run]
            tol = max(MEAN_TOL, 4.0 * sd * (1.0 + 1.0 / n_groups) ** 0.5 / ref)
            rel = abs(mean - ref) / ref
            check(rel < tol, f"{run}: mean {mean} vs the JAX CPU mean {ref} (tol {tol})")
            rec.update({"reference_mean": ref, "rel_err": rel, "rel_tol": tol,
                        "test_seed_rel_err": abs(means[0] - ref) / ref,
                        "reference": "chainrefs: tools/chain_reference_means.py"})
        if run in CHAIN_BARS:
            pr = CHAIN_BARS[run][0]
            rec.update(bar_check(run, imgs[0], wide_path_render(sc, *pr), CHAIN_BARS[run][1]))
            rec["bar"] = CHAIN_BARS[run][1]
        emit(rec)
        firsts[run] = imgs[0]
    # MLT through the BVH: the test's seed of mlt_big, within 1% of the
    # tiled route's image mean
    name, integrator, res, spp, depth, seed, kw = CHAIN_RUNS["mlt_big"]
    cfg = RenderConfig(width=res, height=res, spp=spp, max_depth=depth, seed=seed, accel="bvh")
    (img, secs, lanes, _), counts["chain_mlt_big_bvh"] = drive(
        "chain_mlt_big_bvh", lambda: timed_render(lambda: funcs["mlt"](cs[name], cfg, **kw)),
        {**NONE_LAUNCHED, **chain_launches("mlt", depth, res, spp, kw, bvh=True)})
    r = float(img.mean()) / float(firsts["mlt_big"].mean())
    check(abs(r - 1.0) < 0.01, f"mlt through the BVH: {r} of the tiled route's mean")
    emit({"phase": "chain_mlt_big_bvh", "card": card, "seconds": round(secs, 3),
          "mean": float(img.mean()), "ratio_to_tiled": r, "mrays_per_s": lanes / secs / 1e6})
    ref = wide_path_render(cs["caustic_box"], *CHAIN_PSS_REFERENCE)
    e_ps, e_pss = (float(((firsts[r] - ref) ** 2).mean())
                   for r in ("mlt_caustic_512", "pssmlt_caustic_512"))
    check(e_ps < e_pss, f"path space does not beat PSS on the caustic box: {e_ps} vs {e_pss}")
    emit({"phase": "chain_path_space_vs_pss", "card": card, "mse_path_space": e_ps,
          "mse_pss": e_pss, "mutations_per_pixel": 512})
    return counts


def chain_syncs(cornell):
    """Host syncs (torch's sync debug mode, syncs_per_wave) of one step of
    each chain integrator on the Cornell box at the CLI's defaults: a
    PSSMLT step of 8192 chains, an MLT large step and a perturbation of
    4096, an ERPT seed evaluation with one step of 65536 chains; and of an
    SPPM pass and a photon-mapper camera sample (a render of two less a
    render of one)."""
    import torch

    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.core.spectrum import luminance
    from mitsuba_path_guiding_torch.integrators import erpt, mlt, pssmlt
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    cfg = RenderConfig(width=W, height=H, spp=INT_SPP, max_depth=DEPTH)
    key = rng.base_key(0, device=DEVICE)
    acc = torch.zeros((W * H, 3), device=DEVICE)
    out = {}

    pst = pssmlt.scene_statics(cornell, cfg)
    u = rng.uniform_shape(key, (pssmlt.pss_dims(cfg), 8192))
    c, xy = pssmlt._path_eval(cornell, cfg, u, pst)
    chain = (u, torch.clamp_min(luminance(c), 1e-12), c, xy)
    keys = pssmlt.chain_keys(key, 8192)
    out["pssmlt_step"] = syncs_per_wave(
        lambda: pssmlt._chain_step(cornell, cfg, pst, chain, keys, 1, acc, 0.3), CHAIN_SYNC_CALLS)

    mst = mlt.scene_statics(cornell, cfg)
    s = mlt._trace_path(cornell, cfg, rng.uniform_shape(key, (2 + 3 * DEPTH, 4096)), mst)
    mkeys = rng.fold_in(pssmlt.chain_keys(key, 4096), 1)
    out["mlt_large_step"] = syncs_per_wave(
        lambda: mlt._large_step(cornell, cfg, mst, s, mkeys, acc), CHAIN_SYNC_CALLS)
    out["mlt_perturbation_step"] = syncs_per_wave(
        lambda: mlt._pert_step(cornell, cfg, mst, s, mkeys, acc), CHAIN_SYNC_CALLS)

    u0, kc = erpt.seed_uniforms(key, cfg, pssmlt.pss_dims(cfg))
    ekeys = pssmlt.chain_keys(kc, W * H)
    out["erpt_seed_and_step"] = syncs_per_wave(
        lambda: erpt._redistribute(cornell, cfg, pst, u0, ekeys, acc, 1), CHAIN_SYNC_CALLS)

    funcs = chain_funcs()
    for name, kw1, kw2 in (("sppm_pass", {"n_iterations": 1}, {"n_iterations": 2}),
                           ("photonmapper_sample", {}, {})):
        if name == "photonmapper_sample":
            one = syncs_per_wave(lambda: funcs["photonmapper"](cornell, cfg._replace(spp=1)),
                                 CHAIN_SYNC_CALLS)
            two = syncs_per_wave(lambda: funcs["photonmapper"](cornell, cfg._replace(spp=2)),
                                 CHAIN_SYNC_CALLS)
        else:
            one = syncs_per_wave(lambda: funcs["sppm"](cornell, cfg, **kw1), CHAIN_SYNC_CALLS)
            two = syncs_per_wave(lambda: funcs["sppm"](cornell, cfg, **kw2), CHAIN_SYNC_CALLS)
        out[name] = (two[0] - one[0], {"render_of_one": one, "render_of_two": two})
    return {k: {"syncs": v[0], "by_source_line": v[1]} for k, v in out.items()}


def run_chains(cs, card):
    """The chains phase's renders: the Cornell box through each of
    CHAIN_CLI at the CLI's defaults (256x256, 16 spp, depth 5; render_once,
    the CLI's dispatch), SPPM again through the BVH, each between its own
    launch-count reset and read and held to chain_launches, each rendered
    twice and held bit-equal, its ratio to the path tracer's image at the
    same defaults to CHAIN_CLI_BARS, the BVH route's mean to the tiled
    route's within 1%; the CLI's cornell -I sppm; the JAX tests' runs
    (run_chain_tests, MLT through the BVH among them); the volume photon map against trace_vol
    (VOLPHOTON, its beam estimate repeating bit for bit); the host syncs a
    step.  Returns the launch counts by route."""
    import torch

    from mitsuba_path_guiding_torch import render as cli
    from mitsuba_path_guiding_torch.film.film import read_pfm
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render

    cornell = cs["cornell"]
    cfg = RenderConfig(width=W, height=H, spp=INT_SPP, max_depth=DEPTH)
    path_img = render(cornell, cfg)
    path_mean = float(path_img.mean())
    counts, means = {}, {}
    for name, accel in [(n, "auto") for n in CHAIN_CLI] + [("sppm", "bvh")]:
        route = f"chain_cli_{name}" + ("_bvh" if accel == "bvh" else "")
        c = cfg._replace(accel=accel)
        expect = chain_launches(name, DEPTH, W, INT_SPP, {}, bvh=accel == "bvh")
        (img, secs, lanes, live), counts[route] = drive(
            route, lambda: timed_render(lambda: cli.render_once(name, cornell, c)),
            {**NONE_LAUNCHED, **expect})
        again = cli.render_once(name, cornell, c)
        repeat = bool(torch.equal(img, again))
        check(repeat, f"{route}: a second render differs")
        check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
              f"{route}: image not finite or black")
        means[route] = float(img.mean())
        ratio = means[route] / path_mean
        lo, hi = CHAIN_CLI_BARS[name]
        check(lo < ratio < hi, f"{route}: ratio to the path tracer {ratio}, bar ({lo}, {hi})")
        emit({"phase": route, "card": card, "resolution": f"{W}x{H}", "spp": INT_SPP,
              "max_depth": DEPTH, "accel": accel, "seconds": round(secs, 3), "mean": means[route],
              "path_mean": path_mean, "ratio_to_path": ratio, "bar": [lo, hi],
              "query_lanes": lanes, "live_query_lanes": live,
              "mrays_per_s": lanes / secs / 1e6, "live_mrays_per_s": live / secs / 1e6,
              "repeat_bit_equal": repeat})
    r = means["chain_cli_sppm_bvh"] / means["chain_cli_sppm"]
    check(abs(r - 1.0) < 0.01, f"sppm through the BVH: {r} of the tiled route's mean")

    out = os.path.join(texture_dir(), "cli_sppm.pfm")
    os.makedirs(texture_dir(), exist_ok=True)

    def cli_run():
        torch.cuda.synchronize()
        t0 = time.time()
        cli.main(["cornell", "-I", "sppm", "-o", out])
        return time.time() - t0

    secs, counts["chain_cli_main_sppm"] = drive(
        "chain_cli_main_sppm", cli_run,
        {**NONE_LAUNCHED, **chain_launches("sppm", DEPTH, W, INT_SPP, {}), "trace_fused": 0})
    img = read_pfm(out)
    check(bool((img == img).all()) and abs(float(img.mean()) - means["chain_cli_sppm"]) <= 1e-6
          * means["chain_cli_sppm"], "cli sppm: not render_once's image")
    emit({"phase": "chain_cli_main_sppm", "card": card, "argv": "cornell -I sppm",
          "seconds_with_scene_build": round(secs, 3), "mean": float(img.mean())})

    counts.update(run_chain_tests(cs, card))
    counts["chain_volphoton"] = phase_volphoton(cs["medium_box"], card)
    emit({"phase": "chain_syncs", "card": card, "host_syncs": chain_syncs(cornell)})
    return counts


def phase_volphoton(scene, card):
    """tests/test_volphoton.py on the card: VOLPHOTON's waves of volume
    photons (between a launch-count reset and read: a query a bounce and
    sample_ray's gather a wave) and the beam estimate on its camera rays
    (through the tiled kernel), against trace_vol's mean on the same rays,
    |ratio - 1| < 0.15; the photons and the estimate made twice and held
    bit-equal.  Returns the launch counts."""
    import numpy as np
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.integrators import volphoton
    from mitsuba_path_guiding_torch.integrators.volpath import trace_vol
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    v = VOLPHOTON
    em = kinds_present(scene.emitters)
    n = v["rays"]
    rs = np.random.default_rng(0)
    o = torch.tensor([0.0, 0.0, -1.9], device=DEVICE).expand(n, 3).contiguous()
    ang = rs.uniform(-0.45, 0.45, (n, 2))
    d = np.stack([np.sin(ang[:, 0]), np.sin(ang[:, 1]) * 0.3, np.ones(n)], -1)
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)).to(
        DEVICE)
    hit = intersect_pallas(scene.geo, o, d)
    t_seg = torch.where(hit.valid, hit.t, 4.0)
    taps = torch.from_numpy(rs.random((v["taps"], n)).astype(np.float32)).to(DEVICE)
    lo, inv_cell, g = volphoton.build_vol_grid(scene, v["r"])

    def beam():
        deps = []
        for w in range(v["waves"]):
            rk = rng.ray_keys(rng.base_key(5, device=DEVICE),
                              torch.zeros(v["photons"], dtype=torch.int64, device=DEVICE),
                              torch.arange(w * v["photons"], (w + 1) * v["photons"],
                                           device=DEVICE))
            deps.append(volphoton.volume_photon_pass(scene, rk, max_depth=v["depth"],
                                                     em_kinds=em))
        ph = [torch.cat(x) for x in zip(*deps)]
        return volphoton.beam_estimate(scene, o, d, t_seg, taps, *ph, lo, inv_cell, g, v["r"],
                                       n_emitted=v["photons"] * v["waves"],
                                       n_taps=v["taps"]), float(ph[3].float().mean())

    ((L_beam, ok_share), secs, lanes, _), counts = drive(
        "chain_volphoton", lambda: timed_render(beam),
        {**NONE_LAUNCHED, "intersect_tiled": v["waves"] * v["depth"],
         "gather_rows_t": v["waves"]})
    L_again, _ = beam()
    repeat = bool(torch.equal(L_beam, L_again))
    check(repeat, "volphoton: a second beam estimate differs")
    check(ok_share > 0.05, f"volphoton: medium events on {ok_share} of the deposits")
    acc = torch.zeros((n, 3), device=DEVICE)
    pix = torch.arange(n, device=DEVICE)
    for s in range(v["spp"]):
        rk = rng.ray_keys(rng.base_key(91, device=DEVICE), pix, torch.full_like(pix, s))
        acc = acc + trace_vol(scene, o, d, rk, max_depth=v["depth"], em_kinds=em,
                              mat_types=types_present(scene.mats))[0]
    a, b = float(L_beam.mean()), float((acc / v["spp"]).mean())
    check(b > 1e-4 and abs(a / b - 1.0) < v["bar"], f"volphoton: beam {a} vs trace_vol {b}")
    emit({"phase": "chain_volphoton", "card": card, "photons": v["photons"] * v["waves"],
          "medium_event_share": ok_share, "rays": n, "taps": v["taps"],
          "seconds": round(secs, 3), "beam_mean": a, "trace_vol_mean": b, "ratio": a / b,
          "bar": v["bar"], "repeat_bit_equal": repeat, "query_lanes": lanes})
    return counts

# ---------------------------------------------------------------------------
# 18. "scene_files" (slice 11): the Mitsuba-XML entry point.
# ---------------------------------------------------------------------------

SCENE_DEFAULTS = {"width": W, "height": H, "spp": 16, "max_depth": DEPTH, "rr_depth": 5}
GUIDED_WAVES = 16                      # the CLI's guided default: 4 spp x 4 progressions
SCENE_CKPT_SPP = 8                     # two checkpointed runs of 8 spp against one of 16
DOOR_XML_SPP, DOOR_XML_PROGRESSIONS = 2, 2
DOOR_XML_WAVES = (DOOR_W * DOOR_H // DOOR_WAVE) * DOOR_XML_SPP * DOOR_XML_PROGRESSIONS
KDBENCH_RAYS = 65536
KDBENCH_REPS = 6                       # kdbench's warm-up and its 5 timed calls
CORNELL_TIMING_ROUNDS, DOOR_TIMING_ROUNDS = 2, 1   # ABBA rounds of the XML/built-in timing


def scene_files_dir():
    """Where the scene_files phase writes its XML, PLY and image files."""
    return os.path.join(texture_dir(), "scene_files")


def _floats(xs):
    import numpy as np

    return " ".join(repr(float(x)) for x in np.ravel(np.asarray(xs, dtype=np.float64)))


def write_ply(path, mesh):
    """A binary little-endian PLY of ``mesh``'s float64 vertices (and
    normals), so that the file holds them bit for bit; faces as uchar
    counts of int32 indices."""
    import numpy as np

    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if mesh.normals is not None else [])
    vert = np.empty(len(mesh.vertices), dtype=[(p, "<f8") for p in props])
    for k, p in enumerate("xyz"):
        vert[p] = mesh.vertices[:, k]
        if mesh.normals is not None:
            vert["n" + p] = mesh.normals[:, k]
    face = np.empty(len(mesh.faces), dtype=[("n", "u1"), ("i", "<i4", (3,))])
    face["n"] = 3
    face["i"] = mesh.faces
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {len(vert)}"]
    head += [f"property double {p}" for p in props]
    head += [f"element face {len(face)}", "property list uchar int vertex_indices",
             "end_header"]
    with open(path, "wb") as fh:
        fh.write(("\n".join(head) + "\n").encode("ascii"))
        fh.write(vert.tobytes())
        fh.write(face.tobytes())


def scene_xml(desc, directory, name, settings=None):
    """Write the built-in scene description ``desc`` as Mitsuba XML under
    ``directory`` and return its path.  Every ``to_world`` goes out as a
    ``<matrix>`` of repr floats (the loader's matrix @ eye(4) is exact), a
    tessellated sphere as an object-space PLY mesh of doubles with its
    matrix, and the BSDF and emitter values as repr floats, so that the
    file compiles to the built-in's arrays bit for bit.  ``settings``
    (width, height, spp, max_depth, rr_depth) become the film, sampler and
    integrator elements."""
    import numpy as np

    from mitsuba_path_guiding_torch.scene.builder import _to_world
    from mitsuba_path_guiding_torch.scene.shapes import make_sphere

    def value(key, v):
        if isinstance(v, str):
            return f'<string name="{key}" value="{v}"/>'
        if np.ndim(v) == 0:
            return f'<float name="{key}" value="{_floats(v)}"/>'
        return f'<rgb name="{key}" value="{_floats(v)}"/>'

    def matrix(m):
        return f'<transform name="toWorld"><matrix value="{_floats(m)}"/></transform>'

    def bsdf(b):
        return (f'<bsdf type="{b["type"]}">'
                + "".join(value(k, v) for k, v in b.items() if k != "type") + "</bsdf>")

    os.makedirs(directory, exist_ok=True)
    lines = ['<scene version="0.6.0">']
    if settings:
        lines.append(f'<integrator type="path"><integer name="maxDepth" '
                     f'value="{settings["max_depth"]}"/><integer name="rrDepth" '
                     f'value="{settings["rr_depth"]}"/></integrator>')
    sen = desc["sensor"]
    inner = [value("fov", sen["fov"]), matrix(sen["to_world"])]
    if settings:
        inner.append(f'<film type="hdrfilm"><integer name="width" value="{settings["width"]}"/>'
                     f'<integer name="height" value="{settings["height"]}"/></film>')
        inner.append(f'<sampler type="independent"><integer name="sampleCount" '
                     f'value="{settings["spp"]}"/></sampler>')
    lines.append(f'<sensor type="{sen["type"]}">' + "".join(inner) + "</sensor>")
    plys = {}
    for i, sh in enumerate(desc["shapes"]):
        kind = sh["type"]
        inner = [matrix(_to_world(sh))]
        if kind == "sphere":
            res = sh.get("sphere_res", 32)
            if res not in plys:
                plys[res] = os.path.join(directory, f"{name}_sphere{res}.ply")
                write_ply(plys[res], make_sphere(res, 2 * res))
            kind = "ply"
            inner.insert(0, f'<string name="filename" value="{os.path.basename(plys[res])}"/>')
        elif kind not in ("rectangle", "cube"):
            raise ValueError(f"scene_xml: shape type {kind}")
        inner.append(bsdf(sh["bsdf"]))
        if sh.get("emitter"):
            inner.append('<emitter type="area">'
                         + value("radiance", sh["emitter"]["radiance"]) + "</emitter>")
        lines.append(f'<shape type="{kind}">' + "".join(inner) + "</shape>")
    check(not desc.get("emitters"), "scene_xml: scene-level emitters are not written")
    lines.append("</scene>")
    path = os.path.join(directory, f"{name}.xml")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def scene_differences(a, b, path="scene"):
    """The fields in which two compiled scenes differ, recursively: a
    tensor must equal the other bit for bit (the packed BVH holds int32
    bits in float32 words, some of them NaN patterns) or value for value
    (a -0.0 of a built-in matrix reads back as +0.0 from the XML's
    ``<matrix>``: the loader's matrix @ eye(4) adds +0.0 to it); host
    values equal."""
    import torch

    if a is None or b is None:
        return [] if a is None and b is None else [path]
    if hasattr(a, "_fields"):
        return [d for f in a._fields
                for d in scene_differences(getattr(a, f), getattr(b, f), f"{path}.{f}")]
    if torch.is_tensor(a):
        same = (a.shape == b.shape and a.dtype == b.dtype
                and (bool(torch.equal(_bits(a), _bits(b))) or bool(torch.equal(a, b))))
        return [] if same else [path]
    return [] if a == b else [path]


def cli_run(argv):
    """The CLI's main() on ``argv`` (on DEVICE): (its seconds, the image it
    wrote, a .npy)."""
    import numpy as np
    import torch

    from mitsuba_path_guiding_torch import render as cli

    if DEVICE == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    rc = cli.main(argv + ([] if DEVICE == "cuda" else ["--device", DEVICE]))
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    secs = time.time() - t0
    check(rc == 0, f"CLI {argv}: exit code {rc}")
    return secs, np.load(argv[argv.index("-o") + 1])


def alternating_seconds(xml_fn, builtin_fn, rounds):
    """Seconds of the XML and the built-in run (each a function of no
    arguments giving its seconds), after the counted runs have warmed
    both, in ``rounds`` rounds of ABBA order (BXXB, then XBBX, ...) so
    neither side always runs first: each side's seconds, their medians
    and the ratio of the medians."""
    runs = {"xml": (xml_fn, []), "builtin": (builtin_fn, [])}
    order = []
    for r in range(rounds):
        order += ["builtin", "xml", "xml", "builtin"] if r % 2 == 0 else \
            ["xml", "builtin", "builtin", "xml"]
    for side in order:
        fn, secs = runs[side]
        secs.append(fn())
    med = {side: statistics.median(secs) for side, (_, secs) in runs.items()}
    ratio = med["xml"] / med["builtin"]
    return {"order": "".join("X" if side == "xml" else "B" for side in order),
            "xml_s": runs["xml"][1], "builtin_s": runs["builtin"][1],
            "xml_median_s": med["xml"], "builtin_median_s": med["builtin"],
            "xml_over_builtin": ratio, "within_10pct": abs(ratio - 1.0) <= 0.10}


def png_size(png):
    """(width, height) of a PNG whose IDAT decompresses to its 8-bit RGB
    scanlines; raises on anything else."""
    import struct
    import zlib

    check(png.startswith(b"\x89PNG\r\n\x1a\n"), "preview: /image.png is not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(png):
        n, tag = struct.unpack(">I4s", png[pos:pos + 8])
        data = png[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            size = struct.unpack(">II", data[:8])
        elif tag == b"IDAT":
            idat += data
        pos += 12 + n
    w, h = size
    check(len(zlib.decompress(idat)) == h * (1 + 3 * w), "preview: IDAT does not decode")
    return w, h


def phase_scene_files_cornell(cornell, card):
    """(a)-(c) on the Cornell box written as XML (CLI defaults in its film,
    sampler and integrator): its compile equals the built-in's; the CLI at
    its defaults (guided 4 spp x 4) and with -I path gives images bit-equal
    to the built-in's, each route held to its exact launches; two -s 8 -c
    runs equal one -s 16; --preview 0 serves a finished 256x256 image."""
    import json
    import urllib.request

    import numpy as np

    from mitsuba_path_guiding_torch.scene import scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.xml_loader import load_scene_xml
    from mitsuba_path_guiding_torch.utils import preview as pmod

    d = scene_files_dir()
    xml = scene_xml(scenes.cornell_box(), d, "cornell", SCENE_DEFAULTS)
    t0 = time.time()
    desc, settings = load_scene_xml(xml)
    parse_s = time.time() - t0
    check(settings == {**SCENE_DEFAULTS, "integrator": "path", "sampler": "independent"},
          f"XML Cornell settings {settings}")
    diff = scene_differences(build_scene(desc, device=DEVICE), cornell)
    check(not diff, f"XML Cornell compiles apart from the built-in in {diff}")
    counts, rec = {}, {"phase": "scene_files_cornell", "card": card, "xml_parse_s": parse_s}
    guided = {**NONE_LAUNCHED, "intersect_tiled": 2 * DEPTH * GUIDED_WAVES,
              "gather_rows_t": 3 * DEPTH * GUIDED_WAVES}
    fused = {**NONE_LAUNCHED, "trace_fused": SCENE_DEFAULTS["spp"]}
    imgs = {}
    for label, extra, expect in (("guided", [], guided), ("path", ["-I", "path"], fused)):
        for src, scene_arg in (("xml", xml), ("builtin", "cornell")):
            route = f"scene_files_{src}_{label}"
            out = os.path.join(d, f"{route}.npy")
            (secs, imgs[route]), counts[route] = drive(
                route, lambda: cli_run([scene_arg, "-o", out] + extra), expect)
            rec[f"{route}_s"] = secs
        same = np.array_equal(imgs[f"scene_files_xml_{label}"], imgs[f"scene_files_builtin_{label}"])
        check(same, f"XML Cornell -I {label}: image differs from the built-in's")
        rec[f"{label}_bit_equal"] = same
        rec[f"{label}_mean"] = float(imgs[f"scene_files_xml_{label}"].mean())
        timing_out = os.path.join(d, f"scene_files_timing_{label}.npy")
        rec[f"{label}_timing"] = alternating_seconds(
            *(lambda scene_arg=scene_arg: cli_run([scene_arg, "-o", timing_out] + extra)[0]
              for scene_arg in (xml, "cornell")), CORNELL_TIMING_ROUNDS)

    ckpt = os.path.join(d, "cornell_ckpt.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    half = os.path.join(d, "scene_files_ckpt.npy")
    ck_s = [cli_run([xml, "-s", str(SCENE_CKPT_SPP), "-c", ckpt, "-o", half])[0]
            for _ in range(2)]
    resumed = np.load(half)
    same = np.array_equal(resumed, imgs["scene_files_xml_guided"])
    check(same, "checkpoint: two -s 8 -c runs differ from one -s 16 run")
    rec.update(checkpoint_runs_s=ck_s, checkpoint_bit_equal=same)

    seen = {}
    real_close = pmod.PreviewServer.close

    def close(srv):
        base = f"http://127.0.0.1:{srv.port}"
        seen["status"] = json.loads(urllib.request.urlopen(base + "/status", timeout=10).read())
        seen["png"] = urllib.request.urlopen(base + "/image.png", timeout=10).read()
        real_close(srv)

    pmod.PreviewServer.close = close
    try:
        pv_s, pv_img = cli_run([xml, "--preview", "0", "-o", os.path.join(d, "preview.npy")])
    finally:
        pmod.PreviewServer.close = real_close
    st = seen["status"]
    check(st["finished"] and st["spp"] == SCENE_DEFAULTS["spp"], f"preview: /status {st}")
    check(png_size(seen["png"]) == (W, H), "preview: /image.png is not 256x256")
    check(np.array_equal(pv_img, imgs["scene_files_xml_guided"]), "preview: the render changed")
    rec.update(preview_s=pv_s, preview_status=st, preview_png_bytes=len(seen["png"]))
    emit(rec)
    return xml, counts


def phase_scene_files_door(door, card):
    """(d) door_room written as XML with its spheres as PLY files of
    doubles: the compile (pair tables and blocklist included) equals the
    built-in's; a guided 512x512 render of 2 spp x 2 progressions by the
    pair route equals the built-in's bit for bit, both held to the pair
    route's launches.  Returns (the largest PLY, the launch counts)."""
    import torch

    from mitsuba_path_guiding_torch.scene import scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.xml_loader import load_scene_xml

    d = scene_files_dir()
    t0 = time.time()
    xml = scene_xml(scenes.door_room(), d, "door_room")
    write_s = time.time() - t0
    t0 = time.time()
    desc, _ = load_scene_xml(xml)
    parse_s = time.time() - t0
    t0 = time.time()
    scene = build_scene(desc, device=DEVICE)
    if DEVICE == "cuda":
        torch.cuda.synchronize()
    build_s = time.time() - t0
    diff = scene_differences(scene, door)
    check(not diff, f"XML door_room compiles apart from the built-in in {diff}")
    waves = DOOR_XML_WAVES
    counts, imgs, secs, bl, mt = {}, {}, {}, {}, {}
    for src, sc in (("xml", scene), ("builtin", door)):
        route = f"scene_files_door_{src}"
        retraced = {}

        def run(sc=sc, route=route, retraced=retraced):
            def render():
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                t0 = time.time()
                img = door_render(sc)
                if DEVICE == "cuda":
                    torch.cuda.synchronize()
                return img, time.time() - t0

            (((img, s), bl[route]), mt[route]), retraced["n"] = count_retraces(
                lambda: mt_kernel_time(lambda: blocklist_kernel_time(render)), route)
            return img, s

        (imgs[src], secs[src]), counts[route] = drive(route, run, {
            **NONE_LAUNCHED, **door_gathers(waves), "intersect_pairs_mt": 2 * DEPTH * waves,
            "intersect_blocklist": lambda retraced=retraced: retraced["n"]})
    same = bool(torch.equal(imgs["xml"], imgs["builtin"]))
    check(same, "XML door_room: the render differs from the built-in's")

    def seconds(sc):
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        t0 = time.time()
        door_render(sc)
        if DEVICE == "cuda":
            torch.cuda.synchronize()
        return time.time() - t0

    timing = alternating_seconds(lambda: seconds(scene), lambda: seconds(door), DOOR_TIMING_ROUNDS)
    check(bool(torch.isfinite(imgs["xml"]).all()) and float(imgs["xml"].mean()) > 0.0,
          "XML door_room: image not finite or black")
    emit({"phase": "scene_files_door", "card": card, "resolution": f"{DOOR_W}x{DOOR_H}",
          "spp": DOOR_XML_SPP * DOOR_XML_PROGRESSIONS, "write_s": write_s, "xml_parse_s": parse_s,
          "build_s": build_s, "render_s": secs, "timing": timing, "bit_equal": same,
          "mean": float(imgs["xml"].mean()),
          "launches": {k: {r: c[k] for r, c in counts.items()}
                       for k in ("gather_rows_t", "gather_rows_t_large", "intersect_pairs_mt",
                                 "intersect_blocklist")},
          "blocklist_kernel_ms_sum": {r: v["kernel_ms_sum"] for r, v in bl.items()},
          "mt_kernel_ms_sum": {r: v["kernel_ms_sum"] for r, v in mt.items()}})
    plys = [os.path.join(d, f) for f in os.listdir(d)
            if f.startswith("door_room_") and f.endswith(".ply")]
    return max(plys, key=os.path.getsize), counts


def door_render(scene):
    """door_room guided at 512x512, DOOR_XML_SPP spp x DOOR_XML_PROGRESSIONS."""
    from mitsuba_path_guiding_torch.integrators.progressive import render_progressive, \
        ProgressiveConfig
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    cfg = ProgressiveConfig(render=RenderConfig(width=DOOR_W, height=DOOR_H, spp=0,
                                                max_depth=DEPTH),
                            samples_per_progression=DOOR_XML_SPP,
                            n_progressions=DOOR_XML_PROGRESSIONS, guiding=True)
    return render_progressive(scene, cfg)


def phase_kdbench(paths, card):
    """(e) ``util kdbench`` with 65536 rays on each of ``paths``: on the
    card it times the intersect_tiled kernel, 6 launches (a warm-up and
    5 timed) and nothing else."""
    from mitsuba_path_guiding_torch import util

    counts, rec = {}, {"phase": "scene_files_kdbench", "card": card}
    for label, path in paths.items():
        route = f"scene_files_kdbench_{label}"
        res, counts[route] = drive(route, lambda: util.kdbench(path, KDBENCH_RAYS, DEVICE), {
            **NONE_LAUNCHED, "intersect_tiled": KDBENCH_REPS if DEVICE == "cuda" else 0})
        rec[label] = {**res, "file": os.path.basename(path)}
    emit(rec)
    return counts


def run_scene_files(cornell, door, card):
    """The scene_files phase; returns the launch counts by route."""
    t0 = time.time()
    xml, counts = phase_scene_files_cornell(cornell, card)
    ply, door_counts = phase_scene_files_door(door, card)
    counts.update(door_counts)
    counts.update(phase_kdbench({"cornell_xml": xml, "door_room_ply": ply}, card))
    emit({"phase": "scene_files", "seconds": round(time.time() - t0, 3)})
    return counts


# ---- phase 19, "sharded" (slice 12): render_sharded on one and two ranks

SHARD_RES = 128          # unguided Cornell: SHARD_GROUPS calls of SHARD_SPP spp (64 spp)
SHARD_SPP = 16
SHARD_GROUPS = 4
SHARD_GUIDED_RES = 256   # guided Cornell: 16 spp, the grid fitted every 4 waves
SHARD_GUIDED_SPP = 16
SHARD_FIT_EVERY = 4
SHARD_GUIDED_BAR = 0.08  # tests/test_sharding.py's bar against the unguided render
SHARD_DOOR_TRIS = 120_000
SHARD_DOOR_RES = 128     # tests/test_sharding.py's guided pair-route step
BAND_W, BAND_H, BAND_ROWS, BANDS = 1920, 1080, 2, 2   # dryrun_multichip's 1080p bands


def spawn_ranks(job, world, out_dir, backend="gloo", device="cuda:0", threads=None, **kw):
    """Run ``job`` ("module:function", called as fn(out_dir, device,
    **kw)) on ``world`` ranks, one process each, started by the spawn
    method; the ranks join ``backend`` through a file:// rendezvous in
    ``out_dir`` (no TCP port) and each writes the dict of arrays it
    returns to ``out_dir/rank<k>.npz``.  Returns those dicts in rank
    order.  ``threads``: torch's intra-op threads a rank (default the
    cores over the ranks)."""
    import numpy as np
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    for fn in os.listdir(out_dir):
        if fn == "rendezvous" or fn.startswith("rank"):
            os.remove(os.path.join(out_dir, fn))
    if threads is None:
        threads = max(1, (os.cpu_count() or 1) // world)
    mp.start_processes(_rank_main, args=(job, world, backend, device, threads, out_dir, kw),
                       nprocs=world, join=True, start_method="spawn")
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _rank_main(rank, job, world, backend, device, threads, out_dir, kw):
    import importlib

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    if device.startswith("cuda"):
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="file://" + os.path.join(out_dir, "rendezvous"),
                            world_size=world, rank=rank)
    try:
        mod, fn = job.split(":")
        out = getattr(importlib.import_module(mod), fn)(out_dir, device, **kw)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def _sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def _rank_route(prefix, fn, device):
    """fn() on this rank with the launch and collective counts set to 0
    just before it and read just after it: (fn()'s result, the counts and
    the seconds as arrays under ``prefix``)."""
    import numpy as np

    from mitsuba_path_guiding_torch.ops import build
    from mitsuba_path_guiding_torch.parallel import mesh as pm

    build.reset_launches()
    pm.reset_collectives()
    _sync(device)
    t0 = time.time()
    out = fn()
    _sync(device)
    rec = {f"{prefix}seconds": np.float64(time.time() - t0)}
    rec.update({f"{prefix}launch_{k}": np.int64(v) for k, v in build.LAUNCHES.items()})
    rec.update({f"{prefix}coll_{k}": np.int64(v) for k, v in pm.COLLECTIVES.items()})
    return out, rec


def _grid_rec(prefix, grid):
    from mitsuba_path_guiding_torch.utils.checkpoint import grid_arrays

    return {prefix + k: v for k, v in grid_arrays(grid).items()}


def job_sharded_cornell(out_dir, device, width=SHARD_RES, height=SHARD_RES, spp=SHARD_SPP,
                        depth=DEPTH, groups=1, guided=False, fit_every=SHARD_FIT_EVERY,
                        repeats=1, prefix=""):
    """The Cornell box through render_sharded on this rank: ``repeats``
    runs, each ``groups`` calls of ``spp`` spp at sample offsets 0, spp,
    ..., unguided or guided (alpha 0.5, the default 16^3 grid of 8 lobes,
    fitted every ``fit_every`` waves).  Per run: the images (groups, H,
    W, 3), the segments, the counts and seconds (``_rank_route``) and,
    guided, the grid."""
    import numpy as np

    from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.parallel import mesh as pm
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box

    scene = build_scene(cornell_box(), device=device)
    m = pm.make_device_mesh(device)
    guide = make_guide_fn(0.5, mat_types=types_present(scene.mats)) if guided else None
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=depth, seed=0)
    out = {}
    for run in range(repeats):
        res, rec = _rank_route(f"{prefix}run{run}_", lambda: [
            pm.render_sharded(scene, cfg, m, guide=guide, fit_every=fit_every,
                              sample_offset=g * spp) for g in range(groups)], device)
        out.update(rec)
        out[f"{prefix}img{run}"] = np.stack([img.cpu().numpy() for img, _, _ in res])
        out[f"{prefix}seg{run}"] = np.int64(sum(seg for _, _, seg in res))
        if guided:
            out.update(_grid_rec(f"{prefix}grid{run}_", res[-1][1]))
    return out


def job_sharded_dryrun(out_dir, device, steps=("door_room", "banded_1080p", "volume"),
                       prefix=""):
    """__graft_entry__.dryrun_multichip's steps on this rank, each a
    sharded step of its own:
    - door_room_small: door_room(120000) at 16x16, depth 2, through the
      pair route, on this rank alone and on the mesh (merged films);
    - door_room: the same scene at 128x128, depth 5, guided (an 8^3 grid
      of 4 lobes), one step, the statistics merged and fitted;
    - banded_1080p: a 1920x1080 film rendered in two bands of 2 rows,
      depth 2, guided (min_rough 0.3, a 4^3 grid of 4 lobes), the grid
      fitted after each band and the film merged once;
    - volume: the heterogeneous box (res 8) at 8x8, depth 3, through the
      volumetric tracer with guided distance sampling, fitted once.
    Records each step's film (or its weight), local segments, grid count,
    counts and seconds."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mitsuba_path_guiding_torch.guiding.fit import update_grid
    from mitsuba_path_guiding_torch.guiding.grid import make_grid
    from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.parallel import mesh as pm
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room, heterogeneous_box

    m = pm.make_device_mesh(device)
    out = {}

    def pixels(n, start=0):
        pix = start + torch.arange(n, dtype=torch.int64, device=m.device)
        return pix, torch.zeros_like(pix)

    door = None
    if {"door_room_small", "door_room", "banded_1080p"} & set(steps):
        door = build_scene(door_room(SHARD_DOOR_TRIS), device=device)
        door_guide = make_guide_fn(0.5, mat_types=types_present(door.mats))
    if "door_room_small" in steps:
        singles = [dist.new_group([r]) for r in range(m.world_size)]
        cfg = RenderConfig(width=16, height=16, spp=1, max_depth=2, accel="twolevel")
        for tag, mesh in (("ws1", pm.make_device_mesh(device, group=singles[m.rank])),
                          ("ws2", m)):
            step = pm.make_sharded_step(door, cfg, mesh)
            rgbw, _, _ = step(*pixels(256), pm.init_sharded_film(cfg, mesh), None)
            out[f"{prefix}door_room_small_film_{tag}"] = pm.merge_film(rgbw, mesh).cpu().numpy()
    if "door_room" in steps:
        cfg = RenderConfig(width=SHARD_DOOR_RES, height=SHARD_DOOR_RES, spp=1, max_depth=DEPTH,
                           accel="twolevel")
        grid = make_grid(door.aabb_min, door.aabb_max, res=8, n_lobes=4)
        step = pm.make_sharded_step(door, cfg, m, guide=door_guide)

        def door_step():
            rgbw, stats, n_seg = step(*pixels(SHARD_DOOR_RES ** 2), pm.init_sharded_film(cfg, m),
                                      grid)
            return pm.merge_film(rgbw, m), update_grid(grid, *pm.merge_stats(stats, m)), n_seg

        (film, g, n_seg), rec = _rank_route(f"{prefix}door_room_", door_step, device)
        out.update(rec)
        out[f"{prefix}door_room_film"] = film.cpu().numpy()
        out[f"{prefix}door_room_seg"] = np.int64(int(n_seg.sum()))
        out[f"{prefix}door_room_grid_count"] = np.float64(float(g.s_count.sum()))
    if "banded_1080p" in steps:
        cfg5 = RenderConfig(width=BAND_W, height=BAND_H, spp=1, max_depth=2, accel="twolevel")
        guide5 = make_guide_fn(0.5, mat_types=types_present(door.mats), min_rough=0.3)
        grid5 = make_grid(door.aabb_min, door.aabb_max, res=4, n_lobes=4)
        step5 = pm.make_sharded_step(door, cfg5, m, guide=guide5)
        band_pix = BAND_W * BAND_ROWS

        def banded():
            # one progression: the bands into one film, the grid fitted
            # after each band, the film merged once
            rgbw, g, seg = pm.init_sharded_film(cfg5, m), grid5, 0
            for band in range(BANDS):
                rgbw, stats, n_seg = step5(*pixels(band_pix, band * band_pix), rgbw, g)
                g = update_grid(g, *pm.merge_stats(stats, m))
                seg = seg + n_seg
            return pm.merge_film(rgbw, m), g, seg

        (film, g, seg), rec = _rank_route(f"{prefix}banded_1080p_", banded, device)
        out.update(rec)
        out[f"{prefix}banded_1080p_finite"] = np.bool_(bool(torch.isfinite(film).all()))
        out[f"{prefix}banded_1080p_weight"] = np.float64(float(film[:, 3].sum()))
        out[f"{prefix}banded_1080p_seg"] = np.int64(int(seg.sum()))
        out[f"{prefix}banded_1080p_grid_count"] = np.float64(float(g.s_count.sum()))
    if "volume" in steps:
        vol = build_scene(heterogeneous_box(sigma_s=0.9, sigma_a=0.1, res=8), device=device)
        cfg4 = RenderConfig(width=8, height=8, spp=1, max_depth=3)
        grid4 = make_grid(vol.aabb_min, vol.aabb_max, res=4, n_lobes=4)
        step4 = pm.make_sharded_step(vol, cfg4, m,
                                     guide=make_guide_fn(0.5, mat_types=types_present(vol.mats)),
                                     vol=True, guide_distance=True)

        def volume_step():
            rgbw, stats, n_seg = step4(*pixels(64), pm.init_sharded_film(cfg4, m), grid4)
            return pm.merge_film(rgbw, m), update_grid(grid4, *pm.merge_stats(stats, m)), n_seg

        (film, g, n_seg), rec = _rank_route(f"{prefix}volume_", volume_step, device)
        out.update(rec)
        out[f"{prefix}volume_film_weight"] = np.float64(float(film[:, 3].sum()))
        out[f"{prefix}volume_finite"] = np.bool_(bool(torch.isfinite(film).all()))
        out[f"{prefix}volume_grid_finite"] = np.bool_(bool(torch.isfinite(g.s_count).all()))
        out[f"{prefix}volume_grid_count"] = np.float64(float(g.s_count.sum()))
        out[f"{prefix}volume_seg"] = np.int64(int(n_seg.sum()))
    return out


def job_sharded_chip(out_dir, device):
    """Phase 19's world-size-2 work in one spawn: the unguided Cornell
    renders (prefix u_), the guided one twice (g_) and the dryrun steps."""
    out = job_sharded_cornell(out_dir, device, groups=SHARD_GROUPS, prefix="u_")
    out.update(job_sharded_cornell(out_dir, device, width=SHARD_GUIDED_RES,
                                   height=SHARD_GUIDED_RES, spp=SHARD_GUIDED_SPP, guided=True,
                                   repeats=2, prefix="g_"))
    out.update(job_sharded_dryrun(out_dir, device))
    return out


def _launches(rec, prefix):
    return {k[len(prefix) + 7:]: int(v) for k, v in rec.items()
            if k.startswith(prefix + "launch_")}


def _collectives(rec, prefix):
    return {k[len(prefix) + 5:]: int(v) for k, v in rec.items() if k.startswith(prefix + "coll_")}


def _hold_launches(name, got, want):
    """Every kernel's count on one rank against ``want`` (None: at least
    one; a pair (lo, hi): within it)."""
    for kernel, w in want.items():
        g = got[kernel]
        if w is None:
            check(g > 0, f"{name}: {kernel} was not launched")
        elif isinstance(w, tuple):
            check(w[0] <= g <= w[1], f"{name}: {kernel} launched {g} times, expected {w}")
        else:
            check(g == w, f"{name}: {kernel} launched {g} times, expected {w}")


def sharded_dir(name):
    """Where one spawn of phase 19 rendezvouses and leaves its ranks'
    arrays: build/chip_smoke/sharded/<name> in the checkout."""
    return os.path.join(texture_dir(), "sharded", name)


def run_sharded(card):
    """Phase 19: render_sharded at world size 1 (NCCL) and 2 (gloo, both
    ranks on cuda:0: NCCL refuses two ranks on one card), in processes of
    their own.  Returns the launch counts by route (rank 0's; every
    rank's are held to the same bars)."""
    import numpy as np

    t0 = time.time()
    ws1 = spawn_ranks("chip_smoke:job_sharded_cornell", 1, sharded_dir("ws1_nccl"),
                      backend="nccl", groups=SHARD_GROUPS, prefix="u_")
    ws2 = spawn_ranks("chip_smoke:job_sharded_chip", 2, sharded_dir("ws2_gloo"))
    ranks = {"ws1_nccl_rank0": ws1[0], "ws2_gloo_rank0": ws2[0], "ws2_gloo_rank1": ws2[1]}
    counts = {}

    # unguided: bit-equal across world sizes, the reference mean, the kernels
    waves = SHARD_SPP * SHARD_GROUPS
    unguided_want = {**NONE_LAUNCHED, "intersect_tiled": 2 * DEPTH * waves,
                     "gather_rows_t": 3 * DEPTH * waves}
    ref_img = ws1[0]["u_img0"]
    for label, r in ranks.items():
        check(np.array_equal(r["u_img0"], ref_img), f"sharded unguided {label}: not bit-equal "
                                                    f"to world size 1")
        _hold_launches(f"sharded_unguided_{label}", _launches(r, "u_run0_"), unguided_want)
    group_means = ref_img.reshape(SHARD_GROUPS, -1).mean(axis=1)
    mean = float(group_means.mean())
    se = float(group_means.std(ddof=1) / SHARD_GROUPS ** 0.5)
    tol = max(MEAN_TOL, 4.0 * (CORNELL_REFERENCE_SE ** 2 + se ** 2) ** 0.5
              / CORNELL_REFERENCE_MEAN)
    rel = abs(mean - CORNELL_REFERENCE_MEAN) / CORNELL_REFERENCE_MEAN
    check(rel < tol, f"sharded unguided mean {mean} vs {CORNELL_REFERENCE_MEAN} (tol {tol})")
    counts["sharded_unguided"] = _launches(ws2[0], "u_run0_")

    # guided at world size 2: repeats, equal grids, the JAX test's bar
    guided_want = {**NONE_LAUNCHED, "intersect_tiled": 2 * DEPTH * SHARD_GUIDED_SPP,
                   "gather_rows_t": 3 * DEPTH * SHARD_GUIDED_SPP}
    grid_keys = [k for k in ws2[0] if k.startswith("g_grid0_")]
    for r in ws2:
        check(np.array_equal(r["g_img0"], r["g_img1"]), "sharded guided: runs differ")
        check(np.array_equal(r["g_img0"], ws2[0]["g_img0"]), "sharded guided: ranks differ")
        for k in grid_keys:
            check(np.array_equal(r[k], ws2[0][k]) and np.array_equal(r[k], r[k.replace(
                "grid0", "grid1")]), f"sharded guided: grid field {k} differs")
        for run in (0, 1):
            _hold_launches("sharded_guided", _launches(r, f"g_run{run}_"), guided_want)
    g_mean = float(ws2[0]["g_img0"].mean())
    g_rel = abs(g_mean - mean) / mean
    check(g_rel < SHARD_GUIDED_BAR, f"sharded guided mean {g_mean} vs unguided {mean}")
    check(int(ws2[0]["g_grid0_grid_valid"].sum()) > 0, "sharded guided: no valid cell")
    counts["sharded_guided"] = _launches(ws2[0], "g_run0_")

    # the collectives: one film merge a render_sharded call, one stats merge
    # every fit_every waves, none a wave
    n_fit = SHARD_GUIDED_SPP // SHARD_FIT_EVERY
    coll = {"unguided_ws1": _collectives(ws1[0], "u_run0_"),
            "unguided_ws2": _collectives(ws2[0], "u_run0_"),
            "guided_ws2": _collectives(ws2[0], "g_run0_")}
    check(coll["unguided_ws1"]["merge_film"] == SHARD_GROUPS
          and coll["unguided_ws1"]["all_gather"] == 0, f"world size 1 collectives {coll}")
    check(coll["unguided_ws2"]["all_gather"] == SHARD_GROUPS, f"unguided collectives {coll}")
    check((coll["guided_ws2"]["merge_film"], coll["guided_ws2"]["merge_stats"],
           coll["guided_ws2"]["all_gather"]) == (1, n_fit, 1 + n_fit),
          f"guided collectives {coll}")

    # dryrun_multichip's steps at world size 2
    door_want = {**NONE_LAUNCHED, "intersect_pairs_mt": 2 * DEPTH,
                 "intersect_blocklist": (0, 2 * DEPTH), "gather_rows_t": 3 * DEPTH,
                 "gather_rows_t_large": DEPTH}
    band_want = {**NONE_LAUNCHED, "intersect_pairs_mt": 2 * 2 * BANDS,
                 "intersect_blocklist": (0, 2 * 2 * BANDS), "gather_rows_t": 3 * 2 * BANDS,
                 "gather_rows_t_large": 2 * BANDS}
    n_door = SHARD_DOOR_RES ** 2
    for r in ws2:
        film = r["door_room_film"]
        check(bool(np.isfinite(film).all()) and float(film[:, 3].sum()) == n_door,
              "sharded door_room: film weight is not the pixel count")
        check(float(r["door_room_grid_count"]) > 0, "sharded door_room: empty grid")
        _hold_launches("sharded_door_room", _launches(r, "door_room_"), door_want)
        check(bool(r["banded_1080p_finite"])
              and float(r["banded_1080p_weight"]) == BANDS * BAND_ROWS * BAND_W,
              "sharded 1080p bands: film")
        _hold_launches("sharded_banded_1080p", _launches(r, "banded_1080p_"), band_want)
        check(bool(r["volume_finite"]) and float(r["volume_film_weight"]) == 64
              and bool(r["volume_grid_finite"]) and float(r["volume_grid_count"]) > 0,
              "sharded volume step")
        # three bounces: two tiled queries and three gathers each
        _hold_launches("sharded_volume", _launches(r, "volume_"),
                       {**NONE_LAUNCHED, "intersect_tiled": 2 * 3, "gather_rows_t": 3 * 3})
    door_seg = sum(int(r["door_room_seg"]) for r in ws2)
    check(door_seg > n_door, f"sharded door_room: {door_seg} segments for {n_door} pixels")
    check(sum(_launches(r, "door_room_")["intersect_blocklist"] for r in ws2) > 0,
          "sharded door_room: no blocklist launch")
    for step in ("door_room", "banded_1080p", "volume"):
        counts[f"sharded_{step}"] = _launches(ws2[0], f"{step}_")

    rec = {"phase": "sharded", "card": card, "seconds": round(time.time() - t0, 3),
           "unguided": {"resolution": f"{SHARD_RES}x{SHARD_RES}", "spp": waves, "mean": mean,
                        "se": se, "reference_mean": CORNELL_REFERENCE_MEAN, "rel_err": rel,
                        "rel_tol": tol, "bit_equal_ws1_ws2": True},
           "guided": {"resolution": f"{SHARD_GUIDED_RES}x{SHARD_GUIDED_RES}",
                      "spp": SHARD_GUIDED_SPP, "fit_every": SHARD_FIT_EVERY, "mean": g_mean,
                      "rel_to_unguided": g_rel, "repeats_bit_equal": True,
                      "grids_equal_on_ranks": True},
           "door_room_segments": door_seg, "collectives": coll,
           "collective_bytes_per_progression": {
               "guided_ws2": coll["guided_ws2"]["bytes"] // n_fit,
               "banded_1080p_ws2": _collectives(ws2[0], "banded_1080p_")["bytes"]},
           "seconds_per_rank": {label: {k[:-len("_seconds")]: round(float(v), 3)
                                        for k, v in r.items() if k.endswith("_seconds")}
                                for label, r in ranks.items()},
           "launches_per_rank": {label: {p: _launches(r, p) for p in (
               "u_run0_", "g_run0_", "door_room_", "banded_1080p_", "volume_")
               if f"{p}seconds" in r} for label, r in ranks.items()}}
    emit(rec)
    return counts


# ---- phase 20, "irrcache_subsurface" (slice 12)

IRR_RUNS = {  # name: (scene, resolution, spp, max_depth, seed, kwargs): the JAX tests'
    "irrcache": ("cornell", 16, 8, 4, 5, {"n_records": 512, "rays_per_record": 64}),
    "irrcache_pt": ("cornell", 16, 192, 4, 3, {}),
    "slab": ("slab", 16, 2, 2, 3, {"n_points": 512}),
    "slab_thick": ("slab_thick", 16, 2, 2, 3, {"n_points": 512}),
    "single": ("single", 24, 4, 5, 0, {}),
    "single_weak": ("single_weak", 24, 4, 5, 0, {}),
    "single_g0": ("single", 16, 4, 5, 0, {}),
    "single_g08": ("single_g08", 16, 4, 5, 0, {}),
}
# tools/irrcache_subsurface_reference_means.py (JAX on the CPU, 129.2 s)
IRR_REFERENCE = {  # run: (the JAX CPU mean at its seed, the SE over 4 seeds)
    "irrcache": (0.1350552886724472, 0.011567005774055686),
    "irrcache_pt": (0.11488459259271622, 0.0008866150562744871),
    "slab": (0.07435483485460281, 0.007645248580121338),
    "slab_thick": (0.009688527323305607, 0.0009960007782584194),
    "single": (0.025272216647863388, 0.0003049768881451473),
    "single_weak": (0.007887343876063824, 0.00011615305045516455),
    "single_g0": (0.02494804561138153, 0.0005235547108879096),
    "single_g08": (0.004462489392608404, 7.481898435148167e-05),
}


def irr_launches(run, route):
    """The launches of one IRR_RUNS render on ``route`` ("tiled" or
    "bvh"): a camera pass of depth D is D queries and 2D gathers (the
    shading and material rows), an NEE sample one shadow query and one
    gather (the emitter row), a path bounce two queries and three
    gathers; the cache's overture is a camera pass, a gather wave of
    depth max(D - 2, 1) and an NEE wave; a subsurface pixel sample is a
    camera query, its shading row, an NEE sample and the albedo's
    material row, a single-scattering one four distances of an NEE
    sample, a boundary query and its shading row more, beside its entry
    query; the dipole's 8 NEE passes and its sample rows come first.
    The path tracer's reference is render()'s one trace_fused a wave."""
    _, res, spp, depth, _, kw = IRR_RUNS[run]
    if run == "irrcache_pt":
        return {**NONE_LAUNCHED, "trace_fused": spp}
    if run == "irrcache":
        gd = max(depth - 2, 1)
        queries = depth + 2 * gd + 1 + spp * (depth + 1)
        gathers = 2 * depth + 3 * gd + 1 + spp * (2 * depth + 1)
        large = 0
    elif run.startswith("slab"):
        queries, gathers, large = 8 + 2 * spp, 1 + 8 + 3 * spp, 0
    else:  # single scattering on the sphere (more than 512 triangles)
        queries, gathers, large = 11 * spp, 11 * spp, 5 * spp
    kernel = "intersect_bvh" if route == "bvh" else "intersect_tiled"
    return {**NONE_LAUNCHED, kernel: queries, "gather_rows_t": gathers,
            "gather_rows_t_large": large}


def subsurface_descs(mod):
    """The scenes of tests/test_subsurface.py from a scenes module (the
    port's or the JAX package's): the translucent slab (a dipole cube
    between a point light and the camera), with sigma_a 5 (slab_thick),
    and the single-scattering sphere lit from the side with g 0 and 0.8
    and with sigma_s 0.1 (single_weak)."""
    import numpy as np

    def slab(sigma_a):
        return {"sensor": {"type": "perspective", "fov": 50.0,
                           "to_world": mod.look_at([0, 0, -3], [0, 0, 0])},
                "shapes": [{"type": "cube",
                            "to_world": mod.translate(0, 0, 0) @ np.diag([1.0, 1.0, 0.12, 1.0]),
                            "bsdf": {"type": "diffuse", "reflectance": [0.0] * 3},
                            "subsurface": {"sigma_a": sigma_a, "sigma_s": [1.2, 1.0, 0.8],
                                           "eta": 1.3}}],
                "emitters": [{"type": "point", "position": [0.0, 0.0, 1.5],
                              "intensity": [8.0, 8.0, 8.0]}]}

    def single(g, sigma_s):
        return {"sensor": {"type": "perspective", "fov": 50.0,
                           "to_world": mod.look_at([0, 0, -3], [0, 0, 0])},
                "shapes": [{"type": "sphere", "to_world": np.diag([0.8, 0.8, 0.8, 1.0]),
                            "bsdf": {"type": "diffuse", "reflectance": [0.0] * 3},
                            "subsurface": {"type": "singlescatter", "sigma_a": [0.05] * 3,
                                           "sigma_s": [sigma_s] * 3, "eta": 1.33, "g": g}}],
                "emitters": [{"type": "point", "position": [2.5, 0.0, 0.0],
                              "intensity": [30.0, 30.0, 30.0]}]}

    return {"cornell": mod.cornell_box(), "slab": slab([0.02, 0.04, 0.1]),
            "slab_thick": slab([5.0, 5.0, 5.0]), "single": single(0.0, 0.8),
            "single_weak": single(0.0, 0.1), "single_g08": single(0.8, 0.8)}


def irr_render(run, scenes, accel="auto"):
    """One IRR_RUNS run on the port: its image."""
    from mitsuba_path_guiding_torch.integrators.irrcache import render_irrcache
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_torch.integrators.subsurface import render_subsurface

    name, res, spp, depth, seed, kw = IRR_RUNS[run]
    cfg = RenderConfig(width=res, height=res, spp=spp, max_depth=depth, seed=seed, accel=accel)
    fn = render if run == "irrcache_pt" else (
        render_irrcache if run == "irrcache" else render_subsurface)
    return fn(scenes[name], cfg, **kw)


def irr_kernel_checks(scenes, card):
    """intersect_tiled and the BVH bit-equal to their plain versions,
    closest hit and any-hit, on the irradiance cache's gather rays (the
    first segment of each record's cells) and NEE shadow rays on the
    Cornell box, and on the slab's irradiance samples' NEE shadow rays;
    gather_rows_t bit-equal on the samples' shading rows."""
    import torch

    from mitsuba_path_guiding_torch.integrators import irrcache, subsurface
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    cornell, slab = scenes["cornell"], scenes["slab"]
    _, _, _, _, seed, kw = IRR_RUNS["irrcache"]
    gather = []
    real_trace = irrcache.trace

    def rec_trace(scene, o, d, *a, **k):
        gather.append((o, d))
        return real_trace(scene, o, d, *a, **k)

    irrcache.trace = rec_trace
    try:
        _, calls = record_queries(irrcache, lambda: irrcache.build_irradiance_cache(
            cornell, RenderConfig(width=16, height=16, max_depth=4, seed=seed), **kw))
    finally:
        irrcache.trace = real_trace
    o_g, d_g = gather[0]
    sets = {"irradiance_gather": (cornell, (o_g, d_g, torch.full_like(o_g[:, 0], 3.0e37))),
            "irradiance_nee_shadow": (cornell, [c for c in calls if c[3]][0][:3])}
    rows = []
    real_gather = subsurface.gather_rows_t

    def rec_gather(table, idx):
        rows.append((table, idx))
        return real_gather(table, idx)

    subsurface.gather_rows_t = rec_gather
    try:
        pts = subsurface.sample_surface_points(slab, IRR_RUNS["slab"][5]["n_points"], seed=3)
    finally:
        subsurface.gather_rows_t = real_gather
    _, calls = record_queries(subsurface, lambda: subsurface.compute_irradiance(
        slab, pts, RenderConfig(seed=3)))
    sets["subsurface_nee_shadow"] = (slab, calls[0][:3])
    res = {}
    for label, (sc, (o, d, tmax)) in sets.items():
        res[f"intersect_tiled_{label}"] = tiled_check(sc.geo, o, d, tmax, sc.geo.p0.shape[0],
                                                      label)
        res[f"bvh_{label}"] = bvh_check(sc.bvh, o, d, tmax, label)
    res["gather_rows_t_subsurface_samples"] = gather_call(*rows[0])
    emit({"phase": "irrcache_subsurface_kernel_checks", "card": card, **res})
    return res


def run_irrcache_subsurface(card):
    """Phase 20: the kernel checks, then each IRR_RUNS render (irrcache by
    the tiled route and the BVH, twice each, bit-equal) held to the JAX
    tests' bars and to the JAX package's CPU means.  Returns (the launch
    counts by route, the kernel checks)."""
    import numpy as np

    from mitsuba_path_guiding_torch.scene import scenes as port_scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    t0 = time.time()
    scenes = {k: build_scene(v, device=DEVICE) for k, v in subsurface_descs(port_scenes).items()}
    checks = irr_kernel_checks(scenes, card)
    counts, means, recs = {}, {}, {}
    for run in IRR_RUNS:
        routes = (("tiled", "auto"), ("bvh", "bvh")) if run == "irrcache" else (("tiled", "auto"),)
        for route, accel in routes:
            want = irr_launches(run, route)
            imgs = []
            for rep in range(2 if run == "irrcache" else 1):
                name = f"irr_{run}_{route}" + (f"_{rep}" if rep else "")
                (img, secs, lanes, live), counts[name] = drive(
                    name, lambda: timed_render(lambda: irr_render(run, scenes, accel)), want)
                img = img.cpu().numpy()
                check(bool(np.isfinite(img).all()), f"{name}: not finite")
                imgs.append(img)
                recs[name] = {"seconds": round(secs, 3), "mean": float(img.mean()),
                              "query_lanes": lanes, "live_query_lanes": live,
                              "launches": counts[name]}
            if len(imgs) == 2:
                check(np.array_equal(imgs[0], imgs[1]), f"{run} {route}: repeats differ")
            means[f"{run}_{route}"] = float(imgs[0].mean())
            if run in IRR_REFERENCE:
                ref, se = IRR_REFERENCE[run]
                tol = max(MEAN_TOL, 4.0 * se / ref)
                rel = abs(means[f"{run}_{route}"] - ref) / ref
                check(rel < tol, f"{run} {route}: mean {means[f'{run}_{route}']} vs the JAX "
                                 f"CPU mean {ref} (tol {tol})")
                recs[f"irr_{run}_{route}"].update({"reference_mean": ref, "rel_err": rel,
                                                  "rel_tol": tol})
    # the JAX tests' bars
    ratio = {r: means[f"irrcache_{r}"] / means["irrcache_pt_tiled"] for r in ("tiled", "bvh")}
    for r, v in ratio.items():
        check(0.8 < v < 1.2, f"irrcache ({r}) over the path tracer: {v}")
    check(means["slab_tiled"] > 1e-4, f"slab mean {means['slab_tiled']}")
    check(means["slab_thick_tiled"] < 0.5 * means["slab_tiled"], "sigma_a 5 does not darken")
    check(means["single_tiled"] > 1e-4, f"singlescatter mean {means['single_tiled']}")
    check(means["single_tiled"] > 1.5 * means["single_weak_tiled"], "sigma_s scaling")
    aniso = abs(means["single_g0_tiled"] - means["single_g08_tiled"]) / max(
        means["single_g0_tiled"], 1e-9)
    check(aniso > 0.02, f"singlescatter anisotropy {aniso}")
    emit({"phase": "irrcache_subsurface", "card": card, "seconds": round(time.time() - t0, 3),
          "irrcache_over_path": ratio, "slab_thick_over_slab":
              means["slab_thick_tiled"] / means["slab_tiled"],
          "single_over_weak": means["single_tiled"] / means["single_weak_tiled"],
          "anisotropy_rel": aniso, "renders": recs})
    return counts, checks


# ---- phase 21, "gradients_manifold_spectral_motion" (slice 13)

GRAD_RUNS = {  # name: (scene, rays, seeds, max_depth, key seed, film side): tests/test_grad.py's
    "furnace": ("furnace", 2048, 4, 4, 0, 48),
    "cornell": ("cornell", 1024, 2, 4, 0, 48),
    "emitter": ("cornell", 1024, 1, 3, 1, 32),
}
GRAD_FD_EPS = 1e-2       # the furnace's central difference (test_grad.py)
GRAD_FD_TOL = 0.05
GRAD_JAX_RTOL = 1e-3     # each gradient against JAX's CPU gradient on the same rays
SPECTRAL_RUNS = {  # name: (scene, integrator, resolution, spp, max_depth, seed, n_bins)
    "hero_scan": ("hero", "scan", 16, 48, 3, 2, 4),   # tests/test_spectral.py's
    "hero_bins": ("hero", "bins", 16, 48, 3, 2, 4),
    "dispersive_bins": ("dispersive", "bins", 24, 24, 5, 2, 4),
    "cornell_bins": ("cornell", "bins", 256, 4, 5, 0, 8),
}
MOTION_RUNS = {  # name: (scene, resolution, spp, max_depth, seed, time_bins): test_motion.py's
    "blur_sharp": ("moving_0", 24, 8, 2, 1, 2),
    "blur": ("moving_1.2", 24, 8, 2, 1, 6),
    "deformable": ("deformable", 24, 8, 2, 0, 4),
    "deformable_sharp": ("deformable_sharp", 24, 8, 2, 0, 2),
}
MOTION_VECTOR_RES = 64
SLICE13_SEEDS = 4        # seeds of each spectral and motion run for the standard errors
MANIFOLD_BRUTE_RAYS = 80_000
MANIFOLD_NEE_TOL = 0.08
SH_BASIS_DIRS = 65536


def slice13_descs(mod):
    """The scenes of tests/test_spectral.py and tests/test_motion.py from a
    scenes module (the port's or the JAX package's): the hero plane and
    cube under a 5000 K point light, the dispersive glass sphere over a
    floor, the Cornell box, the sphere moving by 0 and 1.2 along x, and the
    deformable plane sliding by 1 (and its still twin)."""
    import numpy as np

    look_at, rotate, scale, translate = mod.look_at, mod.rotate, mod.scale, mod.translate

    def moving(dx):
        return {"sensor": {"type": "perspective", "fov": 60.0,
                           "to_world": look_at([0, 0, -4], [0, 0, 0])},
                "shapes": [{"type": "sphere", "center": [0, 0, 0], "radius": 0.8,
                            "sphere_res": 16,
                            "animation": {"times": [0.0, 1.0],
                                          "transforms": [translate(0, 0, 0),
                                                         translate(dx, 0, 0)]},
                            "bsdf": {"type": "diffuse", "reflectance": [0.8] * 3}},
                           {"type": "rectangle", "bsdf": {"type": "diffuse"},
                            "to_world": translate(0, 0, 2.0) @ np.diag([4.0, 4.0, 1.0, 1.0])}],
                "emitters": [{"type": "constant", "radiance": [1.0] * 3}]}

    v0 = 0.35 * np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], float)
    v1 = v0 + np.array([1.0, 0.0, 0.0])
    plane = {"type": "deformable", "vertices_frames": [v0, v1],
             "faces": np.array([[0, 1, 2], [0, 2, 3]]),
             "bsdf": {"type": "diffuse", "reflectance": [0.8, 0.2, 0.2]}}

    def ortho(shape):
        return {"sensor": {"type": "orthographic", "to_world": look_at([0, 0, -3], [0, 0, 0])},
                "shapes": [shape],
                "emitters": [{"type": "constant", "radiance": [1.0] * 3}]}

    hero = {"sensor": {"type": "perspective", "fov": 45.0,
                       "to_world": look_at([0, 1.0, -3.0], [0, 0.5, 0])},
            "shapes": [{"type": "rectangle", "to_world": rotate([1, 0, 0], -90) @ scale(2.0),
                        "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.4, 0.2]}},
                       {"type": "cube", "to_world": scale(0.4),
                        "bsdf": {"type": "diffuse", "reflectance": [0.2, 0.5, 0.7]}}],
            "emitters": [{"type": "point", "position": [1.0, 3.0, -1.0],
                          "intensity": [5.0, 5.0, 5.0],
                          "spectrum": {"type": "blackbody", "temperature": 5000.0}}]}
    dispersive = {"sensor": {"type": "perspective", "fov": 40.0,
                             "to_world": look_at([0, 0.4, -3.2], [0, 0, 0])},
                  "shapes": [{"type": "sphere", "center": [0, 0.4, 0], "radius": 0.5,
                              "sphere_res": 24,
                              "bsdf": {"type": "dielectric", "int_ior": 1.52, "cauchy_c": 0.03}},
                             {"type": "rectangle",
                              "to_world": translate(0, -0.4, 0) @ np.array(
                                  [[2, 0, 0, 0], [0, 0, 2, 0], [0, -2, 0, 0], [0, 0, 0, 1.0]])}],
                  "emitters": [{"type": "point", "position": [0.0, 3.0, 0.0],
                                "intensity": [6.0, 6.0, 6.0]}]}
    return {"hero": hero, "dispersive": dispersive, "cornell": mod.cornell_box(),
            "moving_0.4": moving(0.4), "moving_0": moving(0.0), "moving_1.2": moving(1.2),
            "deformable": ortho(plane),
            "deformable_sharp": ortho(dict(plane, vertices_frames=[v0, v0]))}


def wavy_surface(amp=0.05, res=48, span=3.0):
    """tests/test_manifold.py's wavy water surface y = 1 + amp sin(pi x)
    sin(pi z) with analytic vertex normals, as the numpy fields of a
    Geometry (for ``convert.geometry_from_numpy``): 2 res^2 triangles."""
    import numpy as np

    xs = np.linspace(-span, span, res + 1)
    X, Z = np.meshgrid(xs, np.linspace(-span, span, res + 1), indexing="ij")
    V = np.stack([X, 1.0 + amp * np.sin(np.pi * X) * np.sin(np.pi * Z), Z], axis=-1).reshape(-1, 3)
    dhdx = amp * np.pi * np.cos(np.pi * X) * np.sin(np.pi * Z)
    dhdz = amp * np.pi * np.sin(np.pi * X) * np.cos(np.pi * Z)
    N = np.stack([-dhdx, np.ones_like(X), -dhdz], axis=-1)
    N = (N / np.linalg.norm(N, axis=-1, keepdims=True)).reshape(-1, 3)
    idx = np.arange((res + 1) * (res + 1)).reshape(res + 1, res + 1)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([b, d, c], -1)])
    p0 = V[faces[:, 0]]
    e1, e2 = V[faces[:, 1]] - p0, V[faces[:, 2]] - p0
    t = len(faces)
    sp = np.zeros((t, 32), np.float32)
    gn = np.cross(e1, e2)
    sp[:, 0:3] = gn / np.linalg.norm(gn, axis=-1, keepdims=True)
    for k in range(3):
        sp[:, 3 + 3 * k:6 + 3 * k] = N[faces[:, k]]
    z3, z2 = np.zeros((t, 3), np.float32), np.zeros((t, 2), np.float32)
    return {"p0": p0, "e1": e1, "e2": e2, "n0": N[faces[:, 0]], "n1": N[faces[:, 1]],
            "n2": N[faces[:, 2]], "uv0": z2, "uv1": z2, "uv2": z2,
            "mat_id": np.zeros((t,), np.int32), "emitter_id": np.zeros((t,), np.int32),
            "shade_packed": sp}


def grad_scenes(device):
    """The port's scenes of GRAD_RUNS on ``device``."""
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box, furnace

    return {"furnace": build_scene(furnace(albedo=0.5, env_radiance=1.0), device=device),
            "cornell": build_scene(cornell_box(), device=device)}


def grad_rays(scene, n_rays, key_seed, sample, film):
    """Camera rays and keys of tests/test_grad.py (tools/slice13_reference_means.py
    ``jax_rays``) on the scene's device."""
    import torch

    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.models.sensor import generate_rays

    dev = scene.geo.p0.device
    pix = torch.arange(n_rays, device=dev)
    rkeys = rng.ray_keys(rng.base_key(key_seed, device=dev), pix, torch.full_like(pix, sample))
    o, d, _ = generate_rays(scene.sensor, film, film, pix, rng.event_uniform(rkeys, rng.TAG_CAMERA, 2))
    return o, d, rkeys


def port_gradient(run, scenes, n_rays=None, seeds=None, accel="auto"):
    """One GRAD_RUNS gradient by loss.backward() through the port's trace,
    with its test's companion value (the twin of the reference tool's
    ``jax_gradient``): {"grad": ..., "fd" | "base": ...}."""
    import torch

    from mitsuba_path_guiding_torch.integrators.path import trace
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    name, rays, n_seeds, depth, key_seed, film = GRAD_RUNS[run]
    rays = rays if n_rays is None else n_rays
    n_seeds = n_seeds if seeds is None else seeds
    scene = scenes[name]
    ek, mt = kinds_present(scene.emitters), types_present(scene.mats)
    kw = dict(max_depth=depth, em_kinds=ek, mat_types=mt, accel=accel)
    if run == "emitter":
        o, d, rkeys = grad_rays(scene, rays, key_seed, 0, film)
        em, sp = scene.emitters, scene.geo.shade_packed

        def loss(sc_):
            em2 = em._replace(packed=torch.cat([em.packed[:, :2], em.packed[:, 2:5] * sc_,
                                                em.packed[:, 5:]], dim=1),
                              env_radiance=em.env_radiance * sc_)
            geo2 = scene.geo._replace(shade_packed=torch.cat([sp[:, :20], sp[:, 20:23] * sc_,
                                                              sp[:, 23:]], dim=1))
            L, _, _ = trace(scene._replace(emitters=em2, geo=geo2), o, d, rkeys, **kw)
            return L.mean()

        s = torch.ones((), device=o.device, requires_grad=True)
        loss(s).backward()
        with torch.no_grad():
            base = float(loss(torch.ones((), device=o.device)))
        return {"grad": float(s.grad), "base": base}
    waves = [grad_rays(scene, rays, key_seed, k, film) for k in range(n_seeds)]

    def loss(packed):
        sc_ = scene._replace(mats=scene.mats._replace(packed=packed))
        total = 0.0
        for o, d, rkeys in waves:
            L, _, _ = trace(sc_, o, d, rkeys, **kw)
            total = total + L.mean()
        return total / n_seeds

    packed = scene.mats.packed.clone().requires_grad_()
    loss(packed).backward()
    g = packed.grad.cpu().numpy()
    if run == "furnace":
        with torch.no_grad():
            f = []
            for dv in (GRAD_FD_EPS, -GRAD_FD_EPS):
                p = scene.mats.packed.clone()
                p[0, 1:4] += dv
                f.append(float(loss(p)))
        return {"grad": float(g[0, 1:4].sum()) / 3, "fd": (f[0] - f[1]) / (2 * GRAD_FD_EPS * 3)}
    return {"grad": g[:, 1:4].tolist()}


def manifold_points(n, seed, x_span, y_span, x_height=0.0):
    """tests/test_manifold.py's endpoints: n points x at height x_height
    uniform in [-x_span, x_span]^2 (x, z), then n lights y at height 3 in
    [-y_span, y_span]^2, from numpy's generator at ``seed``."""
    import numpy as np

    rs = np.random.default_rng(seed)
    x = np.stack([rs.uniform(-x_span, x_span, n), np.full(n, x_height),
                  rs.uniform(-x_span, x_span, n)], -1).astype(np.float32)
    y = np.stack([rs.uniform(-y_span, y_span, n), np.full(n, 3.0),
                  rs.uniform(-y_span, y_span, n)], -1).astype(np.float32)
    return x, y


def manifold_walk(geo, intersect_fn, x, y, eta_x=1.33, eta_y=1.0):
    """tests/test_manifold.py's ``_walk_setup`` on the port: the first hit
    from x towards y starts the walk.  Returns (WalkResult, eta_x, eta_y)."""
    import torch

    from mitsuba_path_guiding_torch.integrators.manifold import specular_manifold_walk

    n = x.shape[0]
    d0 = (y - x) / torch.linalg.norm(y - x, dim=-1, keepdim=True)
    h0 = intersect_fn(x, d0)
    ex = torch.full((n,), eta_x, device=x.device)
    ey = torch.full((n,), eta_y, device=x.device)
    return specular_manifold_walk(geo, intersect_fn, x, y, h0.prim, h0.u, h0.v, ex, ey), ex, ey


MANIFOLD_FLOOR = ((0.0, 0.0, 0.0), (0.4, 0.0, -0.2), (-0.6, 0.0, 0.5))


def manifold_nee_estimates(geo, intersect_fn, m=512, nb=MANIFOLD_BRUTE_RAYS, le=40.0, half=0.5,
                           eta=1.33):
    """tests/test_manifold.py's manifold-NEE experiment on the port: the
    irradiance at three pool-floor points under a 1 x 1 light at height 3
    through the wavy interface, by manifold NEE (m light samples a point,
    the walk and generalized_geometry) and by brute force (nb cosine rays a
    point refracted through the surface, counted when they reach the
    light).  Returns (manifold estimates, brute-force estimates)."""
    import numpy as np
    import torch

    from mitsuba_path_guiding_torch.integrators.manifold import (
        fresnel_transmittance,
        generalized_geometry,
    )

    dev = geo.p0.device
    rs = np.random.default_rng(3)
    est_m, est_b = [], []
    light_n = torch.tensor([0.0, -1.0, 0.0], device=dev).expand(m, 3)
    for xi in MANIFOLD_FLOOR:
        x = torch.tensor(xi, dtype=torch.float32, device=dev).expand(m, 3).contiguous()
        y = torch.as_tensor(np.stack([rs.uniform(-half, half, m), np.full(m, 3.0),
                                      rs.uniform(-half, half, m)], -1).astype(np.float32),
                            device=dev)
        wr, ex, ey = manifold_walk(geo, intersect_fn, x, y, eta, 1.0)
        dens, w = generalized_geometry(geo, wr, x, y, light_n, ex, ey)
        # Fresnel at z: the incidence measured on the air side
        wo = y - wr.z
        wo = wo / torch.linalg.norm(wo, dim=-1, keepdim=True)
        ft = fresnel_transmittance(torch.abs(torch.sum(wo * wr.normal, -1)), 1.0 / eta)
        contrib = torch.where(wr.converged, le * ft * dens * torch.clamp(w[:, 1], 0.0, 1.0)
                              * (2 * half) ** 2, 0.0)
        est_m.append(float(contrib.mean()))
    sp = geo.shade_packed.cpu().numpy()
    for xi in MANIFOLD_FLOOR:
        u1, u2 = rs.random(nb), rs.random(nb)
        r, phi = np.sqrt(u1), 2 * np.pi * u2
        d = np.stack([r * np.cos(phi), np.sqrt(1 - u1), r * np.sin(phi)], -1).astype(np.float32)
        x = np.tile(np.float32(xi), (nb, 1))
        h = intersect_fn(torch.as_tensor(x, device=dev), torch.as_tensor(d, device=dev))
        prim, u, v = (a.cpu().numpy() for a in (h.prim, h.u, h.v))
        nrm = sp[np.maximum(prim, 0)]
        ns = ((1 - u - v)[:, None] * nrm[:, 3:6] + u[:, None] * nrm[:, 6:9]
              + v[:, None] * nrm[:, 9:12])
        ns = ns / np.linalg.norm(ns, axis=-1, keepdims=True)
        ci = np.sum(d * ns, -1)
        # refract d (water side) through ns into the air
        sin2t = eta**2 * (1 - ci**2)
        tir = sin2t >= 1.0
        refr = -(eta * (-d) + (eta * ci - np.sqrt(np.maximum(1 - sin2t, 0.0)))[:, None] * ns)
        refr = refr / np.maximum(np.linalg.norm(refr, axis=-1, keepdims=True), 1e-12)
        ft = fresnel_transmittance(torch.as_tensor(ci), np.float32(eta)).numpy()
        with np.errstate(over="ignore", invalid="ignore"):  # misses: t is INF
            z = h.t.cpu().numpy()[:, None] * d + x
            tpl = (3.0 - z[:, 1]) / np.where(np.abs(refr[:, 1]) < 1e-9, 1e-9, refr[:, 1])
            py = z + tpl[:, None] * refr
        hit_l = (h.valid.cpu().numpy() & ~tir & (refr[:, 1] > 0) & (np.abs(py[:, 0]) < half)
                 & (np.abs(py[:, 2]) < half))
        est_b.append(float(np.mean(np.where(hit_l, np.pi * ft * le, 0.0))))
    return est_m, est_b


# tools/slice13_reference_means.py (JAX on the CPU, 172.7 s): the gradients
# at GRAD_RUNS; each spectral and motion-blur run's mean at its seed and the
# standard error of a render's mean over SLICE13_SEEDS seeds; the motion
# vectors' summary at MOTION_VECTOR_RES
SLICE13_REFERENCE = {
    "furnace": {"grad": 0.11391873160998027, "fd": 0.11391838391621908},
    "cornell": {"grad": [[0.051611945033073425, 0.032247498631477356, 0.008406225591897964],
                         [0.02021067775785923, 0.014497185125946999, 0.00399782694876194],
                         [0.02259753830730915, 0.013063851743936539, 0.003909738268703222],
                         [0.0, 0.0, 0.0]]},
    "emitter": {"grad": 0.12303949892520905, "base": 0.12303948402404785},
    "hero_scan": (0.02499481476843357, 5.368949859330216e-05),
    "hero_bins": (0.024957701563835144, 4.4972926505861095e-05),
    "dispersive_bins": (0.028030527755618095, 6.006169092528225e-05),
    "cornell_bins": (0.14719967544078827, 0.00015734611299187578),
    "blur_sharp": (0.5231444835662842, 0.0013885112705746812),
    "blur": (0.5257045030593872, 0.0006664993162250292),
    "deformable": (0.9295831322669983, 0.002711676164017571),
    "deformable_sharp": (0.9266992211341858, 0.0005223967641110646),
    "motion_vectors": {"moving": 632, "mean_dx_moving": 6.894992351531982,
                       "max_abs_dy": 7.62939453125e-06, "max_abs_dx": 7.38079833984375,
                       "still": 3464},
}
GRAD_RENDER_RES, GRAD_RENDER_SPP = 64, 2   # render() of the Cornell box with a gradient


def wave_launches(depth, traces, large=False):
    """The launches of ``traces`` calls of trace (or waves of a wavefront
    render) of depth D on an opaque scene of at most BRUTE_FORCE_MAX_TRIS
    triangles: a bounce is a closest-hit and a shadow query of the tiled
    kernel and three gathers (the shading, material and emitter rows), the
    shading row's on a large table when ``large`` (more than 512
    triangles)."""
    return {**NONE_LAUNCHED, "intersect_tiled": 2 * depth * traces,
            "gather_rows_t": 3 * depth * traces,
            "gather_rows_t_large": depth * traces if large else 0}


def grad_launches(run):
    """GRAD_RUNS' launches: the traces of the gradient's loss (the furnace
    also its two finite-difference losses, the emitter its L(1)); the
    backward launches nothing.  The furnace's shading table has more than
    512 rows."""
    _, _, seeds, depth, _, _ = GRAD_RUNS[run]
    traces = {"furnace": 3 * seeds, "cornell": seeds, "emitter": 2}[run]
    return wave_launches(depth, traces, large=run == "furnace")


def ref_gate(name, got, rec):
    """A mean within max(3%, 4 sqrt(SE_ref^2 + SE_card^2)) of the JAX CPU
    mean (SLICE13_REFERENCE), SE_card taken as SE_ref: these runs' card
    means at a seed are JAX's at that seed to 1.3e-7 relative (the
    spectral Cornell box's fused stream aside), so a second card seed
    would measure the reference's spread again."""
    ref, se = SLICE13_REFERENCE[name]
    tol = max(MEAN_TOL, 4.0 * (2.0 * se * se) ** 0.5 / ref)
    rel = abs(got - ref) / ref
    check(rel < tol, f"{name}: mean {got} vs the JAX CPU mean {ref} (tol {tol})")
    rec.update({"reference_mean": ref, "rel_err": rel, "rel_tol": tol})


def slice13_kernel_checks(scene, descs, card):
    """The gather's backward on the card through GatherRowsT bit-equal to
    autograd's gradient of the plain version on the card (Cornell's
    shading table at a 256x256 camera wave's hits: repeated rows and
    misses), timed beside its forward; the tiled kernel's closest hit with
    a gradient (winner_with_grad) bit-equal to the kernel's, its gradient
    against tiled_plain's under autograd; intersect_tiled bit-equal to its
    plain version on the manifold walk's re-projection rays (the wavy
    surface, 4608 triangles) and on render_motion's first-hit rays."""
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import INF, intersect_pallas, tri_pack_rows
    from mitsuba_path_guiding_torch.convert import geometry_from_numpy
    from mitsuba_path_guiding_torch.integrators import motion
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.ops.gather import (
        GatherRowsT,
        gather_rows_t,
        gather_rows_t_plain,
        gather_rows_t_vjp,
    )
    from mitsuba_path_guiding_torch.ops.intersect_tiled import intersect_tiled, tiled_plain
    from mitsuba_path_guiding_torch.scene.animation import scene_at_time
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    res = {}
    table = scene.geo.shade_packed
    r, c = table.shape
    o, d, _ = camera_rays(scene, 1, 0)
    n = o.shape[0]
    idx = intersect_pallas(scene.geo, o, d).prim
    g = torch.randn((c, n), generator=torch.Generator(device=DEVICE).manual_seed(21),
                    device=DEVICE)
    tab = table.clone().requires_grad_()
    out = gather_rows_t(tab, idx)
    check(type(out.grad_fn).__name__.startswith(GatherRowsT.__name__),
          "gather_rows_t with a gradient does not run through GatherRowsT")
    out.backward(g)
    plain = table.clone().requires_grad_()
    gather_rows_t_plain(plain, idx).backward(g)
    torch.cuda.synchronize()
    check(torch.equal(out.detach(), gather_rows_t_plain(table, idx)), "GatherRowsT forward")
    check(torch.equal(tab.grad, plain.grad), "GatherRowsT backward differs from autograd's")
    distinct = int(torch.unique(idx.long().clamp(0, r - 1)).numel())
    b_ms, b_by = bound(n * idx.element_size() + c * n * 4 + r * c * 4, c * n)
    plain2 = table.clone().requires_grad_()
    res["gather_rows_t_backward"] = {
        "ms": cuda_ms(lambda: gather_rows_t_vjp(table.shape, idx, g)),
        "plain_ms": cuda_ms(lambda: torch.autograd.grad(gather_rows_t_plain(plain2, idx), plain2,
                                                        g)),
        "library_ms": cuda_ms(lambda: torch.zeros_like(table).index_add_(
            0, idx.long().clamp(0, r - 1), g.T)),
        "bound_ms": b_ms, "bound_by": b_by, "bit_equal": True, "rows": r, "columns": c,
        "indices": n, "distinct_rows": distinct, "misses": int((idx < 0).sum())}
    # a miss's -1 clamps to row 0 in the kernel; index_select, timed beside
    # it, asserts on an index out of range
    res["gather_rows_t_wave_hits"] = gather_call(table, idx.clamp_min(0))
    # the tiled kernel's closest hit with a gradient
    pack = tri_pack_rows(scene.geo)
    n_tri = scene.geo.p0.shape[0]
    tmax = torch.full((n,), INF, device=DEVICE)
    with torch.no_grad():
        want = intersect_tiled(pack, o, d, tmax, n_tri)
    grads = []
    for fn in (intersect_tiled, tiled_plain):
        o2, d2 = o.clone().requires_grad_(), d.clone().requires_grad_()
        hit = fn(pack, o2, d2, tmax, n_tri)
        if fn is intersect_tiled:
            for name, a, b in zip(("t", "prim", "u", "v", "valid"), hit, want):
                check(torch.equal(_bits(a), _bits(b)), f"winner_with_grad: {name} differs")
        (hit[0].clamp_max(1e3).sum() + hit[2].sum() + hit[3].sum()).backward()
        grads.append(torch.cat([o2.grad, d2.grad]))
    close = torch.isclose(grads[0], grads[1], rtol=1e-5, atol=1e-6)
    check(bool(close.all()), f"winner_with_grad: gradient differs from tiled_plain's on "
                             f"{int((~close).sum())} components")
    res["intersect_tiled_closest_with_grad"] = {
        "rays": n, "bit_equal": True,
        "grad_bit_equal": bool(torch.equal(grads[0], grads[1])),
        "grad_max_abs_diff": float((grads[0] - grads[1]).abs().max())}
    # the manifold walk's re-projection rays
    geo = geometry_from_numpy(wavy_surface(), device=DEVICE)
    gpack = tri_pack_rows(geo)
    rays = []

    def rec(o_, d_):
        rays.append((o_, d_))
        return intersect_pallas(geo, o_, d_, pack=gpack)

    x, y = manifold_points(256, 0, 1.5, 0.4)
    manifold_walk(geo, rec, torch.as_tensor(x, device=DEVICE), torch.as_tensor(y, device=DEVICE))
    mo, md = (torch.cat([r_[k] for r_ in rays]) for k in (0, 1))
    res["intersect_tiled_manifold_reprojection"] = tiled_check(
        geo, mo, md, torch.full((mo.shape[0],), INF, device=DEVICE), geo.p0.shape[0],
        "manifold_reprojection")
    # render_motion's first-hit rays
    res_mv = MOTION_VECTOR_RES
    _, calls = record_queries(motion, lambda: motion.render_motion(
        descs["moving_0.4"], RenderConfig(width=res_mv, height=res_mv, spp=1), device=DEVICE))
    scene0 = build_scene(scene_at_time(descs["moving_0.4"], 0.0), device=DEVICE)
    res["intersect_tiled_motion_first_hit"] = tiled_check(
        scene0.geo, *calls[0][:3], scene0.geo.p0.shape[0], "motion_first_hit")
    emit({"phase": "slice13_kernel_checks", "card": card, **res})
    return res


def slice13_gradients(card):
    """tests/test_grad.py's three gradients through trace on the card, held
    to the test's bars and to JAX's CPU gradients on the same rays
    (GRAD_JAX_RTOL); render() of the Cornell box with mats.packed
    requiring grad takes the wavefront (no trace_fused) and its gradient
    agrees with the same render's on the CPU; the fused wrapper called
    directly on a table that requires grad raises."""
    import numpy as np
    import torch

    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_torch.ops.fused_path import build_fused_tables, trace_fused_cuda

    scenes = grad_scenes(DEVICE)
    counts, recs = {}, {}
    for run in GRAD_RUNS:
        name = f"grad_{run}"
        (got, secs, lanes, live), counts[name] = drive(
            name, lambda: timed_render(lambda: port_gradient(run, scenes)), grad_launches(run))
        want = SLICE13_REFERENCE[run]
        gv, wv = np.asarray(got["grad"]), np.asarray(want["grad"])
        check(bool(np.isfinite(gv).all()), f"{name}: not finite")
        err = float(np.abs(gv - wv).max() / np.abs(wv).max())
        check(err <= GRAD_JAX_RTOL, f"{name}: {gv} vs JAX's {wv} (rel {err})")
        rec = {"seconds": round(secs, 3), "grad": got["grad"], "jax_grad": want["grad"],
               "rel_err_vs_jax": err, "launches": counts[name]}
        if run == "furnace":
            fd_rel = abs(gv - got["fd"]) / abs(got["fd"])
            check(gv != 0.0 and fd_rel < GRAD_FD_TOL, f"furnace: grad {gv} vs fd {got['fd']}")
            rec.update({"fd": got["fd"], "grad_vs_fd_rel": fd_rel})
        elif run == "cornell":
            nz = int((np.abs(gv).sum(axis=1) > 0).sum())
            check(nz >= 3, f"cornell: {nz} reflectances with influence")
            rec["materials_with_influence"] = nz
        else:
            lin = abs(float(gv) - got["base"]) / got["base"]
            check(lin < 1e-4, f"emitter: dL/dscale {gv} vs L(1) {got['base']}")
            rec.update({"base": got["base"], "grad_vs_base_rel": lin})
        recs[name] = rec
    # render() with a table that requires grad takes the wavefront
    cfg = RenderConfig(width=GRAD_RENDER_RES, height=GRAD_RENDER_RES, spp=GRAD_RENDER_SPP)
    grads = {}
    for dev in (DEVICE, "cpu"):
        sc = scenes["cornell"] if dev == DEVICE else grad_scenes("cpu")["cornell"]
        packed = sc.mats.packed.clone().requires_grad_()

        def run_render(sc=sc, packed=packed):
            render(sc._replace(mats=sc.mats._replace(packed=packed)), cfg).mean().backward()
            return packed.grad

        if dev == DEVICE:
            grads[dev], counts["grad_render"] = drive(
                "grad_render", run_render, wave_launches(DEPTH, GRAD_RENDER_SPP))
        else:
            grads[dev] = run_render()
    gc, gcpu = grads[DEVICE].cpu().numpy(), grads["cpu"].numpy()
    err = float(np.abs(gc - gcpu).max() / np.abs(gcpu).max())
    check(err <= GRAD_JAX_RTOL, f"render's gradient on the card vs the CPU's: rel {err}")
    tables = build_fused_tables(scenes["cornell"])
    tables = tables._replace(mat_rows=tables.mat_rows.clone().requires_grad_())
    o, d, rkeys = camera_rays(scenes["cornell"], 1, 0, w=16, h=16)
    try:
        trace_fused_cuda(tables, o, d, rkeys)
        raised = ""
    except RuntimeError as e:
        raised = str(e)
    check(raised.startswith("trace_fused:"), f"trace_fused took a table that requires grad: "
                                             f"{raised!r}")
    emit({"phase": "slice13_gradients", "card": card, "runs": recs,
          "render_grad": {"resolution": GRAD_RENDER_RES, "spp": GRAD_RENDER_SPP,
                          "rel_err_vs_cpu": err, "launches": counts["grad_render"]},
          "trace_fused_refuses": raised})
    return counts


def slice13_manifold(card):
    """tests/test_manifold.py on the card through the tiled kernel: the
    walk converges on > 95% of the wavy surface's lanes with Snell's law at
    the solution and repeats bit for bit; generalized_geometry within a 5%
    median of finite differences; manifold NEE within 8% of brute force
    with MANIFOLD_BRUTE_RAYS rays a point."""
    import numpy as np
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pallas, tri_pack_rows
    from mitsuba_path_guiding_torch.convert import geometry_from_numpy
    from mitsuba_path_guiding_torch.integrators.manifold import generalized_geometry

    def setup(**kw):
        geo = geometry_from_numpy(wavy_surface(**kw), device=DEVICE)
        pack = tri_pack_rows(geo)
        return geo, lambda o, d: intersect_pallas(geo, o, d, pack=pack)

    def dev(a):
        return torch.as_tensor(a, device=DEVICE)

    t0 = time.time()
    counts = {}
    geo, isect = setup()
    x, y = manifold_points(256, 0, 1.5, 0.4)
    (wr, _, _), counts["manifold_walk"] = drive(
        "manifold_walk", lambda: manifold_walk(geo, isect, dev(x), dev(y)),
        {**NONE_LAUNCHED, "intersect_tiled": 13})
    wr2, _, _ = manifold_walk(geo, isect, dev(x), dev(y))
    for f in wr._fields:
        check(torch.equal(_bits(getattr(wr, f)), _bits(getattr(wr2, f))),
              f"manifold walk: {f} does not repeat")
    conv = wr.converged.cpu().numpy()
    check(conv.mean() > 0.95, f"only {conv.mean()} of the walks converged")
    z, nrm = wr.z.cpu().numpy(), wr.normal.cpu().numpy()
    wi = (x - z) / np.linalg.norm(x - z, axis=-1, keepdims=True)
    wo = (y - z) / np.linalg.norm(y - z, axis=-1, keepdims=True)
    sin_i = np.linalg.norm(np.cross(wi, nrm), axis=-1)[conv]
    sin_o = np.linalg.norm(np.cross(wo, nrm), axis=-1)[conv]
    snell = float(np.abs(1.33 * sin_i - sin_o).max())
    check(bool(np.allclose(1.33 * sin_i, sin_o, rtol=2e-3, atol=2e-4)), f"Snell: {snell}")
    # generalized_geometry against finite differences of the walk
    geo4, isect4 = setup(amp=0.04)
    x4, y4 = manifold_points(64, 2, 1.0, 0.3)
    wr4, ex, ey = manifold_walk(geo4, isect4, dev(x4), dev(y4))
    light_n = torch.tensor([0.0, -1.0, 0.0], device=DEVICE).expand(64, 3)
    dens, w0 = generalized_geometry(geo4, wr4, dev(x4), dev(y4), light_n, ex, ey)
    eps = 1e-3
    ws = []
    for tv in (np.float32([1, 0, 0]), np.float32([0, 0, 1])):
        wp = manifold_walk(geo4, isect4, dev(x4), dev(y4 + eps * tv))[0].z.cpu().numpy() - x4
        wm = manifold_walk(geo4, isect4, dev(x4), dev(y4 - eps * tv))[0].z.cpu().numpy() - x4
        wp /= np.linalg.norm(wp, axis=-1, keepdims=True)
        wm /= np.linalg.norm(wm, axis=-1, keepdims=True)
        ws.append((wp - wm) / (2 * eps))
    w0n = w0.cpu().numpy()
    up = np.where(np.abs(w0n[:, 1:2]) < 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    b1 = np.cross(w0n, up)
    b1 /= np.linalg.norm(b1, axis=-1, keepdims=True)
    b2 = np.cross(w0n, b1)
    fd = np.abs(np.sum(b1 * ws[0], -1) * np.sum(b2 * ws[1], -1)
                - np.sum(b1 * ws[1], -1) * np.sum(b2 * ws[0], -1))
    ok = wr4.converged.cpu().numpy()
    med = float(np.median(np.abs(dens.cpu().numpy()[ok] - fd[ok]) / np.maximum(fd[ok], 1e-9)))
    check(med < 0.05, f"generalized_geometry vs finite differences: median {med}")
    # manifold NEE against brute force
    geo40, isect40 = setup(amp=0.04, res=40)
    t1 = time.time()
    (est_m, est_b), counts["manifold_nee"] = drive(
        "manifold_nee", lambda: manifold_nee_estimates(geo40, isect40),
        {**NONE_LAUNCHED, "intersect_tiled": 3 * 13 + 3})
    nee_s = time.time() - t1
    ratios = [a / b for a, b in zip(est_m, est_b)]
    check(all(abs(r_ - 1.0) < MANIFOLD_NEE_TOL for r_ in ratios), f"manifold NEE {ratios}")
    emit({"phase": "slice13_manifold", "card": card, "seconds": round(time.time() - t0, 3),
          "converged": float(conv.mean()), "snell_max_abs": snell, "repeat_bit_equal": True,
          "gg_vs_fd_median_rel": med, "nee_manifold": est_m, "nee_brute": est_b,
          "nee_ratio": ratios, "nee_seconds": round(nee_s, 3), "brute_rays": MANIFOLD_BRUTE_RAYS,
          "launches": counts})
    return counts


def slice13_sh(card):
    """eval_basis at 4 bands on SH_BASIS_DIRS directions within 1e-6 of the
    same call on the CPU; sample_sh on the card passes tests/test_sh.py's
    chi^2 (120000 samples of a band-1 expansion, res 48)."""
    import numpy as np
    import torch

    from mitsuba_path_guiding_torch.core import chi2, rng, sh

    gen = np.random.default_rng(0)
    dd = gen.standard_normal((SH_BASIS_DIRS, 3))
    dd = (dd / np.linalg.norm(dd, axis=-1, keepdims=True)).astype(np.float32)
    got = sh.eval_basis(torch.as_tensor(dd, device=DEVICE), 4).cpu()
    diff = float((got - sh.eval_basis(torch.as_tensor(dd), 4)).abs().max())
    check(diff <= 1e-6, f"eval_basis on the card vs the CPU: {diff}")
    res = 48
    c = sh.project(lambda v: (v[..., 2] + 1.2) * 0.5, 2, device=DEVICE)
    u = rng.uniform_shape(rng.base_key(3, device=DEVICE), (120_000, 2))
    dirs, _ = sh.sample_sh(c, u, res=res)
    ct = 1.0 - (np.arange(res) + 0.5) * (2.0 / res)
    ph = (np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi
    CT, PH = np.meshgrid(ct, ph, indexing="ij")
    ST = np.sqrt(np.maximum(1 - CT * CT, 0.0))
    dg = np.stack([ST * np.cos(PH), ST * np.sin(PH), CT], -1).reshape(-1, 3).astype(np.float32)
    vals = np.maximum(sh.eval_sh(c, torch.as_tensor(dg, device=DEVICE)).cpu().numpy(), 1e-9)
    pmf = (vals / vals.sum()).reshape(res, 2 * res)
    cell_sa = (2.0 / res) * (2 * np.pi / (2 * res))

    def pdf_fn(v):
        iy = np.clip(((1.0 - v[:, 2]) / (2.0 / res)).astype(int), 0, res - 1)
        ix = np.clip(((np.arctan2(v[:, 1], v[:, 0]) % (2 * np.pi))
                      / (2 * np.pi / (2 * res))).astype(int), 0, 2 * res - 1)
        return pmf[iy, ix] / cell_sa

    passed, p, msg = chi2.chi2_test_sphere(dirs.cpu().numpy(), pdf_fn)
    check(passed, f"sample_sh chi^2: {msg}")
    emit({"phase": "slice13_sh", "card": card, "eval_basis_max_abs_vs_cpu": diff,
          "directions": SH_BASIS_DIRS, "sample_sh_chi2_p": p})


def slice13_renders(table, fn, launches):
    """Each run of ``table`` (SPECTRAL_RUNS or MOTION_RUNS) at its seed on
    the card, twice (bit-equal), each render driven with its launches; the
    mean held to the JAX CPU mean with ref_gate.  Returns (images, counts,
    records)."""
    import numpy as np

    imgs, counts, recs = {}, {}, {}
    for run in table:
        for name in (run, f"{run}_repeat"):
            (img, secs, lanes, live), counts[name] = drive(
                name, lambda: timed_render(lambda: fn(run, table[run][-2])), launches(run))
            img = np.asarray(img.cpu() if hasattr(img, "cpu") else img)
            check(bool(np.isfinite(img).all()), f"{name}: not finite")
            if name == run:
                imgs[run] = img
                recs[run] = {"seconds": round(secs, 3), "query_lanes": lanes,
                             "launches": counts[name], "mean": float(img.mean())}
            else:
                check(np.array_equal(img, imgs[run]), f"{run}: the repeat differs")
                recs[run].update({"repeat_seconds": round(secs, 3), "repeat_bit_equal": True})
        ref_gate(run, recs[run]["mean"], recs[run])
    return imgs, counts, recs


def large_tables(descs):
    """Which of slice13_descs' scenes have a shading table of more than 512
    rows (at time 0)."""
    from mitsuba_path_guiding_torch.ops.gather import SMALL_ROWS
    from mitsuba_path_guiding_torch.scene.animation import scene_at_time
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    return {k: build_scene(scene_at_time(v, 0.0), device=DEVICE).geo.p0.shape[0] > SMALL_ROWS
            for k, v in descs.items()}


def slice13_spectral(descs, card):
    """SPECTRAL_RUNS on the card: render_spectral_scan against
    render_spectral on the hero scene (mean ratio within 6%, mean abs
    difference within 25%: tests/test_spectral.py's bars), the dispersive
    sphere by bins finite with mean > 1e-3 (the scan's dispersive branch is
    held to JAX on the CPU, tests/test_torch_motion_spectral.py), the spectral Cornell box through
    trace_fused (one launch a bin a sample), each mean held to the JAX CPU
    mean, each repeat bit-equal."""
    import numpy as np

    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.integrators.spectral import (
        _groups,
        render_spectral,
        render_spectral_scan,
    )

    def fn(run, seed):
        name, kind, res, spp, depth, _, n_bins = SPECTRAL_RUNS[run]
        cfg = RenderConfig(width=res, height=res, spp=spp, max_depth=depth, seed=seed)
        f = render_spectral_scan if kind == "scan" else render_spectral
        return f(descs[name], cfg, n_bins=n_bins, device=DEVICE)

    def launches(run):
        name, kind, res, spp, depth, _, n_bins = SPECTRAL_RUNS[run]
        if name == "cornell":
            return {**NONE_LAUNCHED, "trace_fused": n_bins * spp}
        waves = spp * (len(_groups(descs[name], n_bins)[0]) if kind == "scan" else n_bins)
        return wave_launches(depth, waves, large[name])

    t0 = time.time()
    large = large_tables(descs)
    imgs, counts, recs = slice13_renders(SPECTRAL_RUNS, fn, launches)
    ratio = float(imgs["hero_scan"].mean() / imgs["hero_bins"].mean())
    rel = float(np.abs(imgs["hero_scan"] - imgs["hero_bins"]).mean() / imgs["hero_bins"].mean())
    check(abs(ratio - 1.0) < 0.06 and rel < 0.25, f"hero scan vs bins: {ratio}, {rel}")
    check(imgs["dispersive_bins"].mean() > 1e-3, "the dispersive sphere is black")
    emit({"phase": "slice13_spectral", "card": card, "seconds": round(time.time() - t0, 3),
          "hero_scan_over_bins": ratio, "hero_mean_abs_rel": rel, "renders": recs})
    return counts


def slice13_motion(descs, card):
    """render_motion on the moving sphere at MOTION_VECTOR_RES with
    tests/test_motion.py's checks and its summary against JAX's; the
    MOTION_RUNS blurs held to the JAX CPU means, the blur smearing the
    sphere's edge (gradient ratio < 0.8) and the deformable plane covering
    more pixels than its still twin."""
    import numpy as np

    from mitsuba_path_guiding_torch.integrators.motion import render_motion, render_motion_blur
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    t0 = time.time()
    large = large_tables(descs)
    res = MOTION_VECTOR_RES
    (mv, secs, _, _), c_mv = drive(
        "motion_vectors", lambda: timed_render(lambda: render_motion(
            descs["moving_0.4"], RenderConfig(width=res, height=res, spp=1), device=DEVICE)),
        {**NONE_LAUNCHED, "intersect_tiled": 1})
    mv = mv.cpu().numpy()
    check(bool(np.isfinite(mv).all()), "motion vectors not finite")
    moving = np.abs(mv[..., 0]) > 0.2
    check(moving.sum() > 10 and bool((mv[..., 0][moving] > 0).all()), "motion: not along +x")
    check(np.abs(mv[..., 1]).max() < np.abs(mv[..., 0]).max() * 0.2, "motion: dy too large")
    check((np.abs(mv[..., 0]) < 1e-5).sum() > mv[..., 0].size * 0.3, "motion: background moves")
    summary = {"moving": int(moving.sum()), "mean_dx_moving": float(mv[..., 0][moving].mean()),
               "max_abs_dy": float(np.abs(mv[..., 1]).max()),
               "max_abs_dx": float(np.abs(mv[..., 0]).max()),
               "still": int((np.abs(mv[..., 0]) < 1e-5).sum())}
    want = SLICE13_REFERENCE["motion_vectors"]
    check(abs(summary["moving"] - want["moving"]) <= 0.01 * want["moving"]
          and abs(summary["mean_dx_moving"] / want["mean_dx_moving"] - 1.0) < 1e-3,
          f"motion vectors {summary} vs JAX's {want}")

    def fn(run, seed):
        name, r, spp, depth, _, bins = MOTION_RUNS[run]
        cfg = RenderConfig(width=r, height=r, spp=spp, max_depth=depth, seed=seed)
        return render_motion_blur(descs[name], cfg, time_bins=bins, device=DEVICE)

    def launches(run):
        name, _, spp, depth, _, bins = MOTION_RUNS[run]
        return wave_launches(depth, spp * bins, large[name])

    imgs, counts, recs = slice13_renders(MOTION_RUNS, fn, launches)
    counts["motion_vectors"] = c_mv
    gx = {k: float(np.abs(np.diff(imgs[k].mean(-1), axis=1)).max()) for k in ("blur_sharp", "blur")}
    check(gx["blur"] < 0.8 * gx["blur_sharp"], f"motion blur does not smear: {gx}")
    # the plane's red tint covers more pixels blurred than still; the JAX
    # test's red-dominant share (R > 1.5 B) is printed: at its seed it
    # passes by one pixel of 576 on the CPU and fails at seeds 1 and 3
    tinted = {k: float((imgs[k][..., 0] > imgs[k][..., 2] + 0.01).mean())
              for k in ("deformable", "deformable_sharp")}
    check(tinted["deformable"] > 1.25 * tinted["deformable_sharp"], f"deformable blur: {tinted}")
    cover = {k: float((imgs[k][..., 0] > 1.5 * imgs[k][..., 2]).mean())
             for k in ("deformable", "deformable_sharp")}
    emit({"phase": "slice13_motion", "card": card, "seconds": round(time.time() - t0, 3),
          "motion_vectors": {**summary, "seconds": round(secs, 3), "jax": want},
          "edge_gradient": gx, "red_tinted": tinted, "red_dominant": cover, "renders": recs})
    return counts


def run_slice13(card):
    """Phase 21: the kernel checks, then the gradients, the manifold walks,
    spherical harmonics, spectral and motion renders.  Returns (the launch
    counts by route, the kernel checks)."""
    import numpy as np

    from mitsuba_path_guiding_torch.scene import scenes as port_scenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box

    t0 = time.time()
    emit({"phase": "gradients_manifold_spectral_motion", "numpy": np.__version__})
    descs = slice13_descs(port_scenes)
    checks = slice13_kernel_checks(build_scene(cornell_box(), device=DEVICE), descs, card)
    counts = slice13_gradients(card)
    counts.update(slice13_manifold(card))
    slice13_sh(card)
    counts.update(slice13_spectral(descs, card))
    counts.update(slice13_motion(descs, card))
    emit({"phase": "gradients_manifold_spectral_motion_done", "card": card,
          "seconds": round(time.time() - t0, 3)})
    return counts, checks


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
    # the shading breadth, last: its kernel checks on the new ray
    # distributions, then its routes
    shading = shading_scenes()
    phase_shading_kernel_checks(shading, veach)
    c_shading = run_shading(shading, veach, card)
    # the scene vocabulary: its kernel checks at the new shapes, then its
    # renders
    vocab = vocabulary_scenes()
    vocab_checks = phase_vocabulary_kernel_checks(vocab, card)
    c_vocab = run_vocabulary(vocab, scene, card)
    # volumes: the kernel checks on medium-event rays, then the renders
    vols = volume_scenes()
    vol_checks = phase_volume_kernel_checks(vols, card)
    c_vol, _, _ = run_volumes(vols, scene, card)
    # the film's splat against index_add_, outside every route's counts
    phase_splat_cost(scene, card)
    # textures, cloth and the denoiser: the kernel checks at the new
    # tables, then the renders and the CLI's --denoise
    texs = texture_scenes()
    tex_checks = phase_texture_kernel_checks(texs, card)
    c_tex = run_textures(texs, scene, card)
    # the light-path and auxiliary integrators: the kernel checks on their
    # rays, then the renders and the CLI's -I bdpt
    ics = integrator_scenes()
    int_checks = phase_integrator_kernel_checks(ics, card)
    c_int = run_integrators(ics, card)
    # the Markov-chain and photon-map integrators: the kernel checks on
    # their rays, then the renders
    chs = chain_scenes()
    chain_checks = phase_chain_kernel_checks(chs, card)
    c_chain = run_chains(chs, card)
    # the scene files: the XML Cornell box through the CLI, checkpoints and
    # the preview, door_room from PLY files, util kdbench
    c_files = run_scene_files(scene, door, card)
    # multi-GPU: render_sharded on one rank (NCCL) and two (gloo), in
    # processes of their own
    c_sharded = run_sharded(card)
    # the irradiance cache and subsurface scattering: the kernel checks on
    # their rays, then the renders
    c_irr, irr_checks = run_irrcache_subsurface(card)
    # gradients, manifold walks, spherical harmonics, spectral rendering and
    # motion: the kernel checks (the gather's backward among them), then the
    # gradients and renders
    c_s13, s13_checks = run_slice13(card)
    routes = {"progressive": c_prog, "frozen_render": c_frozen, "unguided_render": c_render,
              "progressive_adaptive": c_adaptive, "guiding_gain_bounce_lamp": c_bounce,
              "guiding_gain_door_room": c_door_gain,
              "door_room_progressive": c_door, "door_room_plk": c_plk, **interior["launches"],
              "door_room_twolevel": door_tl["launches"], "door_room_sorted_blocklist": c_sorted,
              "door_room_bvh": c_bvh, **c_shading, **c_vocab, **c_vol, **c_tex, **c_int,
              **c_chain, **c_files, **c_sharded, **c_irr, **c_s13}
    launches = {k: {r: c[k] for r, c in routes.items()} for k in c_prog}

    entries = phase_timings(scene, veach, tables, grid, checks, launches, card)
    entries += phase_door_timings(door, checks, launches, bl_calls, bl_rows, bl_render,
                                  mt_render)
    new_entries, gather_calls = phase_new_timings(interior, door_tl, door, launches, card)
    entries[0]["calls"].update(gather_calls)
    entries[0]["calls"].update({"coat_table_random": vocab_checks["gather_rows_t_coat_random"],
                                "coat_table_wave": vocab_checks["gather_rows_t_coat_wave"],
                                "volbox_shading_rows": vol_checks["gather_rows_t_volbox_shading"],
                                "vertex_colour_table_wave": tex_checks["gather_rows_t_vcol_wave"],
                                "light_path_emitter_hits":
                                    int_checks["gather_rows_t_emitter_hits"],
                                "mlt_bootstrap_hits":
                                    chain_checks["gather_rows_t_mlt_bootstrap_hits"],
                                "subsurface_sample_rows":
                                    irr_checks["gather_rows_t_subsurface_samples"],
                                "cornell_wave_hits": s13_checks["gather_rows_t_wave_hits"]})
    entries[0]["backward"] = s13_checks["gather_rows_t_backward"]
    entries += new_entries
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
