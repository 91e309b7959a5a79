#!/usr/bin/env python3
"""One of the port's redesigned kernels against another version of its
source, in one process on one NVIDIA card.

  python3 tools/kernel_ab.py --kernel pairs_mt OLD/csrc/intersect_pairs.cu
  python3 tools/kernel_ab.py --kernel pairs_plk OLD/csrc/intersect_pairs.cu
  python3 tools/kernel_ab.py --kernel intersect_tiled OLD/csrc/intersect_tiled.cu
  python3 tools/kernel_ab.py --kernel trace_fused OLD/csrc/fused_path.cu
  python3 tools/kernel_ab.py --kernel gather_rows_t OLD/csrc/gather_rows.cu
  python3 tools/kernel_ab.py --kernel intersect_bvh OLD/csrc/intersect_bvh.cu
  python3 tools/kernel_ab.py --kernel intersect_twolevel OLD/csrc/intersect_twolevel.cu \
      [VARIANT/csrc/intersect_twolevel.cu ...]

OLD is another version of the source (with its ``device_math.cuh``
beside it), for example a ``git archive`` of an earlier commit unpacked
into a directory that .gitignore lists.  It is built with the port's nvcc
flags and bound in place of the current kernel's C entry points for the
"old" turns.

  - pairs_mt and pairs_plk, on door_room() (244838 triangles, 512x512):
    the sorted pairs of chip_smoke's timed camera wave (the second
    131072-ray wave) and of a first bounce of that wave, closest hit and
    any-hit, through the MT or the Pluecker tiles: the two versions'
    outputs torch.equal, then CUDA-event medians of 7 in turns old, new,
    new, old, with the L2 warm and again evicted before each call
    (tri_cols is 78 MB); then the guided door_room render through the pair
    route with that engine (160 tile launches), old, new, new, old, with
    the tile kernel's time summed over its launches (CUDA events around
    every launch).
  - intersect_tiled, on cornell_box() (36 triangles) and veach_mis() (3850):
    chip_smoke's timed wave of 65536 camera rays, closest hit and any-hit:
    t, prim, u, v, valid and the any-hit flags equal, then medians of 7,
    old, new, new, old, and the kernel's own card time from torch.profiler
    in the same turns (``profiled_ms``: cuda_ms's times of a kernel this
    short hold about 4 us of start event and launch).
  - trace_fused, on cornell_box() with the grid of chip_smoke's guided
    progressive render: the 524288-lane frozen wave of chip_smoke's timings,
    guided and unguided: rows 0:16 torch.equal on every lane, then medians
    of 7, old, new, new, old; then the frozen-cache render's 16 waves, old,
    new, new, old, in seconds, Mrays/s and the kernel's summed time.
  - gather_rows_t, at chip_smoke's two shapes: Cornell's 36x32 shading
    table with 65536 random int32 indices, and door_room's 244838x32
    shading table with the hits of chip_smoke's BVH camera wave and of
    its first bounce: outputs torch.equal, then medians of 7, old, new,
    new, old, with the L2 warm and again evicted before each call (the
    door_room table is 31 MB, within the 50 MB L2), beside
    torch.index_select(...).T.contiguous().
  - intersect_bvh, on door_room(): chip_smoke's BVH camera wave and its
    first bounce, closest hit and any-hit: t, prim, u, v and the triangle
    tests equal, and on closest hit the new box tests equal to the old
    count (the parent's kernel counts nodes popped), then medians of 7,
    old, new, new, old, with the L2 warm and again evicted before each
    call (the packed tree is 16.4 MB); then the unguided BVH render of chip_smoke (40
    launches), old, new, new, old, with the kernel's time summed over its
    launches twice: CUDA events around each launch in the render (the
    host's enqueue included) and each launch replayed alone (cuda_ms).
  - intersect_twolevel, on chip_smoke's three waves of the two-level
    kernel: the interior scene's sorted camera and bounce waves (524288
    rays each, 37 superblocks) and door_room()'s sorted camera wave
    (262144 rays, 30 superblocks), each with the kernel's inputs as
    intersect_blocks_sorted gives them: out (t, prim, u, v) and the work
    counts equal on every lane and tile, then medians of 7 in turns old,
    new, new, old, with the L2 warm and again evicted before each call
    (the interior pack is 19.4 MB), beside the bound and the tests-run
    floor.  Further sources (variants of the kernel, for levers) are
    checked and timed in the same turns: old, new, the variants, the
    variants again, new, old.

The fused kernel keeps its ray counter in a __device__ variable of its own
library and zeroes it in its C entry point, so both versions take the
same arguments.  Each result is one JSON line; the card's name and power
limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bind_old(build, source, name, entries):
    """Build ``source`` as lib<name>_old.so and bind its entry points with
    the argument types of the current ones: {key: ctypes function}."""
    target = os.path.join(build.BUILD_DIR, f"lib{name}_old.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", target, source],
                          capture_output=True, text=True)
    with open(target[:-3] + ".log", "w") as f:  # the ptxas report, as build.py keeps it
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(target)
    old = {}
    for key, f in entries.items():
        g = getattr(lib, key)
        g.argtypes, g.restype = f.argtypes, f.restype
        old[key] = g
    return old


def in_turns(cs, fn, versions, fns, cold=False):
    """fn() timed in turns old, new, new, old with fns (the wrapper's
    entry-point table) holding each version's entry points in turn; with
    ``cold``, the L2 evicted before each call (chip_smoke.cuda_ms)."""
    times = {"old": [], "new": []}
    for v in ("old", "new", "new", "old"):
        fns.update(versions[v])
        times[v].append(cs.cuda_ms(fn, cold=cold))
    fns.update(versions["new"])
    return times


def profiled_ms(fn, kernel, reps=20):
    """The card time of the kernels named ``kernel`` per call of fn, from
    torch.profiler (CUPTI): the kernel alone, without the start event and
    launch that cuda_ms's times hold (about 4 us on an H100)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if kernel in e.key)
    return us / reps / 1e3


def both(versions, fns, fn):
    """fn()'s result under each version: {"old": ..., "new": ...}."""
    out = {}
    for v in ("old", "new"):
        fns.update(versions[v])
        out[v] = fn()
    fns.update(versions["new"])
    return out


def ab_pairs(cs, build, source, engine):
    import torch

    from mitsuba_path_guiding_torch.integrators import path
    from mitsuba_path_guiding_torch.ops import intersect_pairs as ip
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    new = {f"pair_{engine}_{k}": ip._kernel_fn(engine, k == "any") for k in ("closest", "any")}
    versions = {"new": new, "old": bind_old(build, source, "intersect_pairs", new)}
    kern = ip.mt_tiles if engine == "mt" else ip.plk_tiles
    door = build_scene(door_room(), device="cuda")
    tabs = (door.pairs.tri_rows,) if engine == "mt" else (door.pairs.tri_cols, door.pairs.tri_rows)
    o, d, _ = cs.camera_rays(door, 1, 9, w=cs.DOOR_W, h=cs.DOOR_H)
    o, d = o[cs.DOOR_WAVE:2 * cs.DOOR_WAVE], d[cs.DOOR_WAVE:2 * cs.DOOR_WAVE]
    tmax = torch.full((cs.DOOR_WAVE,), 3.0e37, device=o.device)
    waves = {"camera_wave": (o, d, tmax), "first_bounce": cs.first_bounce(door, o, d, tmax, 4)}
    for label, (oo, dd, tt) in waves.items():
        pdata, tile_block = cs._pair_set(door, oo, dd, tt)
        work = cs.mt_tile_work(door.pairs, pdata, tile_block)
        for any_hit in (False, True):
            def call():
                return kern(*tabs, tile_block, pdata, any_hit)
            outs = both(versions, ip._FN, call)
            torch.cuda.synchronize()
            cs.check(torch.equal(outs["old"].view(torch.int32), outs["new"].view(torch.int32)),
                     f"{label} any_hit={any_hit}: old and new {engine} kernels differ")
            times = in_turns(cs, call, versions, ip._FN)
            cold = in_turns(cs, call, versions, ip._FN, cold=True)
            cs.emit({"call": label, "engine": engine, "any_hit": any_hit,
                     "pairs": pdata.shape[1], "live_tiles": int((tile_block >= 0).sum()), **work,
                     "equal": True, "old_ms": times["old"], "new_ms": times["new"],
                     "old_ms_l2_cold": cold["old"], "new_ms_l2_cold": cold["new"],
                     "speedup": statistics.mean(times["old"]) / statistics.mean(times["new"]),
                     "speedup_l2_cold": statistics.mean(cold["old"])
                     / statistics.mean(cold["new"])})
    engine_before = path.PAIR_ENGINE
    path.PAIR_ENGINE = engine
    try:
        for v in ("old", "new", "new", "old"):
            ip._FN.update(versions[v])
            rec, t = cs.kernel_time(
                lambda: cs.phase_door_progressive(door, cs.DOOR_SPP, "door_room_progressive"),
                ip, f"{engine}_tiles")
            cs.emit({"render": "pair", "engine": engine, "version": v,
                     "seconds": rec["seconds"], "mrays_per_s": rec["mrays_per_s"],
                     "mean": rec["mean"], **t})
    finally:
        path.PAIR_ENGINE = engine_before
        ip._FN.update(versions["new"])


def ab_intersect_tiled(cs, build, source):
    import torch

    from mitsuba_path_guiding_torch.ops import intersect_tiled as it
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box, veach_mis

    new = {f"intersect_tiled_{k}": it._kernel_fn(k == "any") for k in ("closest", "any")}
    old = bind_old(build, source, "intersect_tiled", new)
    # the wrapper's table holds the entry points under "closest" and "any"
    versions = {v: {k.rsplit("_", 1)[1]: f for k, f in fns.items()}
                for v, fns in (("new", new), ("old", old))}
    for label, desc in (("cornell", cornell_box()), ("veach_mis", veach_mis())):
        scene = build_scene(desc, device="cuda")
        g = scene.geo
        pack = it.pack_triangles(g.p0, g.e1, g.e2)
        n_tri = g.p0.shape[0]
        o, d, _ = cs.camera_rays(scene, 1, 2000)
        tmax = torch.full((o.shape[0],), 3.0e37, device=o.device)
        for any_hit in (False, True):
            def call():
                return it.intersect_tiled_cuda(pack, o, d, tmax, n_tri, any_hit)
            outs = both(versions, it._FN, call)
            torch.cuda.synchronize()
            pairs = zip(outs["old"], outs["new"]) if not any_hit else [(outs["old"], outs["new"])]
            cs.check(all(torch.equal(cs._bits(a), cs._bits(b)) for a, b in pairs),
                     f"{label} any_hit={any_hit}: old and new tiled kernels differ")
            times = in_turns(cs, call, versions, it._FN)
            kernel = {"old": [], "new": []}
            for v in ("old", "new", "new", "old"):
                it._FN.update(versions[v])
                kernel[v].append(profiled_ms(call, "intersect_tiled_kernel"))
            it._FN.update(versions["new"])
            hits = outs["new"] if any_hit else outs["new"][4]
            cs.emit({"call": label, "any_hit": any_hit, "rays": o.shape[0], "triangles": n_tri,
                     "hit_share": float(hits.float().mean()), "equal": True,
                     "old_ms": times["old"], "new_ms": times["new"],
                     "old_kernel_ms": kernel["old"], "new_kernel_ms": kernel["new"],
                     "speedup": statistics.mean(times["old"]) / statistics.mean(times["new"]),
                     "kernel_speedup": statistics.mean(kernel["old"])
                     / statistics.mean(kernel["new"])})


def ab_trace_fused(cs, build, source, card):
    import torch

    from mitsuba_path_guiding_torch.ops import fused_path as fp
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box

    new = {"trace_fused_launch": fp._kernel_fn()}
    old = bind_old(build, source, "fused_path", new)
    # the wrapper's table holds the entry point under "trace_fused"
    versions = {"new": {"trace_fused": new["trace_fused_launch"]},
                "old": {"trace_fused": old["trace_fused_launch"]}}
    scene = build_scene(cornell_box(), device="cuda")
    grid = cs.phase_progressive(scene)
    tables = fp.build_fused_tables(scene)
    o, d, rkeys = cs.camera_rays(scene, 8, 3000)
    guide_tab, meta = fp._pack_guide(grid)
    for guided in (True, False):
        kw = dict(max_depth=cs.DEPTH, rr_depth=5, guided=guided, alpha=0.5)

        def call():
            return fp.trace_fused_cuda(tables, o, d, rkeys, guide_tab, meta, **kw)
        outs = both(versions, fp._FN, call)
        torch.cuda.synchronize()
        differ = (outs["old"].view(torch.int32) != outs["new"].view(torch.int32)).any(dim=0)
        cs.check(not bool(differ.any()),
                 f"guided={guided}: rows 0:16 of old and new differ on {int(differ.sum())} lanes")
        times = in_turns(cs, call, versions, fp._FN)
        new_out = outs["new"]
        cs.emit({"call": "frozen_wave", "guided": guided, "lanes": o.shape[0],
                 "path_segments": int(new_out[10].sum()), "bounce_loops": int(new_out[14].sum()),
                 "shadow_triangle_tests": int(new_out[15].sum()), "equal": True,
                 "old_ms": times["old"], "new_ms": times["new"],
                 "speedup": statistics.mean(times["old"]) / statistics.mean(times["new"])})
    for v in ("old", "new", "new", "old"):
        fp._FN.update(versions[v])
        (_, rec), t = cs.kernel_time(lambda: cs.phase_frozen(scene, grid, card), fp,
                                     "trace_fused_cuda")
        cs.emit({"render": "frozen", "version": v, "seconds": rec["seconds"],
                 "mrays_per_s": rec["mrays_per_s"], "mean": rec["mean"], **t})
    fp._FN.update(versions["new"])


def ab_gather_rows_t(cs, build, source):
    import torch

    from mitsuba_path_guiding_torch.ops import gather as ga
    from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_cuda
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box, door_room

    new = {f"gather_rows_t_{k}": ga._kernel_fn(dt) for k, dt in (("i32", torch.int32),
                                                                  ("i64", torch.int64))}
    old = bind_old(build, source, "gather_rows", new)
    # the wrapper's table holds the entry points under "i32" and "i64"
    versions = {v: {k[-3:]: f for k, f in fns.items()} for v, fns in (("new", new), ("old", old))}
    cornell = build_scene(cornell_box(), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    table = cornell.geo.shade_packed
    calls = {"cornell": (table, torch.randint(0, table.shape[0], (cs.W * cs.H,), generator=g,
                                              device="cuda", dtype=torch.int32))}
    door = build_scene(door_room(), device="cuda")
    for label, (oo, dd, tt) in bvh_waves(cs, door).items():
        prim = bvh_cuda(door.bvh, oo, dd, tt)[1]
        calls[f"door_room_{label}"] = (door.geo.shade_packed, prim.clamp_min(0))
    for label, (tab, idx) in calls.items():
        def call():
            return ga.gather_rows_t_cuda(tab, idx)
        outs = both(versions, ga._FN, call)
        torch.cuda.synchronize()
        cs.check(torch.equal(outs["old"], outs["new"]), f"{label}: old and new gathers differ")
        times = in_turns(cs, call, versions, ga._FN)
        cold = in_turns(cs, call, versions, ga._FN, cold=True)
        rec = cs.gather_call(tab, idx)
        cs.emit({"call": label, "shape": rec["shape"], "distinct_rows": rec["distinct_rows"],
                 "equal": True, "old_ms": times["old"], "new_ms": times["new"],
                 "old_ms_l2_cold": cold["old"], "new_ms_l2_cold": cold["new"],
                 "library_ms": rec["library_ms"], "bound_ms": rec["bound_ms"],
                 "speedup": statistics.mean(times["old"]) / statistics.mean(times["new"]),
                 "speedup_l2_cold": statistics.mean(cold["old"]) / statistics.mean(cold["new"])})


def bvh_waves(cs, door):
    """chip_smoke's BVH timing waves: the second 131072-ray camera wave of
    door_room at 512x512 (seed 11) and its first bounce (seed 6)."""
    import torch

    o, d, _ = cs.camera_rays(door, 1, 11, w=cs.DOOR_W, h=cs.DOOR_H)
    o, d = o[cs.DOOR_WAVE:2 * cs.DOOR_WAVE], d[cs.DOOR_WAVE:2 * cs.DOOR_WAVE]
    tmax = torch.full((cs.DOOR_WAVE,), 3.0e37, device=o.device)
    return {"camera": (o, d, tmax), "bounce": cs.first_bounce(door, o, d, tmax, 6)}


def bvh_entry(build, fns):
    """A call with ``bvh_cuda``'s contract through one version's entry
    points ({any_hit: function})."""
    import torch

    def call(bvh, o, d, tmax, any_hit=False):
        n, dev = o.shape[0], o.device
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        prim = torch.empty((n,), dtype=torch.int32, device=dev)
        u, v = torch.empty_like(t), torch.empty_like(t)
        counts = torch.empty((2, n), dtype=torch.int32, device=dev)
        o, d, tmax = o.contiguous(), d.contiguous(), tmax.contiguous()
        args = (o, d, tmax, n, bvh.packed_nodes, bvh.packed_tris, bvh.packed_tris.shape[0],
                t, prim, u, v, counts)
        ptrs = [x if isinstance(x, int) else build.ptr(x) for x in args]
        build.check(fns[any_hit](*ptrs, build.stream_ptr(dev)), "intersect_bvh")
        return t, prim, u, v, counts
    return call


def ab_intersect_bvh(cs, build, source, card):
    import torch

    from mitsuba_path_guiding_torch.ops import intersect_bvh as ib
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    new = {f"bvh_{k}": ib._kernel_fn(k == "any") for k in ("closest", "any")}
    old = bind_old(build, source, "intersect_bvh", new)
    door = build_scene(door_room(), device="cuda")
    calls = {v: bvh_entry(build, {False: fns["bvh_closest"], True: fns["bvh_any"]})
             for v, fns in (("new", new), ("old", old))}
    for label, (oo, dd, tt) in bvh_waves(cs, door).items():
        for any_hit in (False, True):
            args = (door.bvh, oo, dd, tt, any_hit)
            outs = {v: calls[v](*args) for v in ("old", "new")}
            torch.cuda.synchronize()
            same = all(torch.equal(cs._bits(a), cs._bits(b))
                       for a, b in zip(outs["old"][:4], outs["new"][:4]))
            cs.check(same, f"{label} any_hit={any_hit}: old and new t, prim, u, v differ")
            cw_old, cw_new = outs["old"][4], outs["new"][4]
            cs.check(torch.equal(cw_old[1], cw_new[1]), f"{label}: triangle tests differ")
            if not any_hit:
                cs.check(torch.equal(cw_old[0], cw_new[0]),
                         f"{label}: box tests differ from the old count")
            times = {"old": [], "new": []}
            cold = {"old": [], "new": []}
            for v in ("old", "new", "new", "old"):
                times[v].append(cs.cuda_ms(lambda: calls[v](*args)))
            for v in ("old", "new", "new", "old"):
                cold[v].append(cs.cuda_ms(lambda: calls[v](*args), cold=True))
            boxes, tests = int(cw_new[0].sum()), int(cw_new[1].sum())
            # a warp runs to its longest walk
            per_ray = cw_new[0][:oo.shape[0] // 32 * 32].reshape(-1, 32)
            b_ms, _ = cs.bound(cs.DOOR_WAVE * (7 + 4 + 2) * 4,
                               boxes * cs.BOX_OPS + tests * cs.BVH_MT_OPS)
            cs.emit({"call": label, "any_hit": any_hit, "rays": oo.shape[0], "equal": True,
                     "old_count0": int(cw_old[0].sum()), "box_tests": boxes,
                     "triangle_tests": tests, "bound_ms": b_ms,
                     "box_tests_ray_mean": boxes / oo.shape[0],
                     "box_tests_ray_max": int(per_ray.max()),
                     "box_tests_warp_max_mean": float(per_ray.max(dim=1).values.float().mean()),
                     "old_ms": times["old"], "new_ms": times["new"],
                     "old_ms_l2_cold": cold["old"], "new_ms_l2_cold": cold["new"],
                     "speedup": statistics.mean(times["old"]) / statistics.mean(times["new"]),
                     "speedup_l2_cold": statistics.mean(cold["old"])
                     / statistics.mean(cold["new"])})
    real = ib.bvh_cuda
    try:
        for v in ("old", "new", "new", "old"):
            launched = []

            def capture(*a, call=calls[v], **kw):
                launched.append((a, kw))
                return call(*a, **kw)
            ib.bvh_cuda = capture
            rec, t = cs.kernel_time(lambda: cs.phase_door_bvh_render(door, card), ib, "bvh_cuda")
            # the events around each launch in the render also hold the
            # host's enqueue of it; each launch again, timed alone on the
            # card (cuda_ms), gives the card's time
            device = sum(cs.cuda_ms(lambda: calls[v](*a, **kw), reps=3, warmup=1)
                         for a, kw in launched)
            cs.emit({"render": "bvh", "version": v, "seconds": rec["seconds"],
                     "mrays_per_s": rec["mrays_per_s"], "mean": rec["mean"], **t,
                     "device_ms_sum": device})
    finally:
        ib.bvh_cuda = real


def ab_intersect_twolevel(cs, build, sources):
    import torch

    from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
    from mitsuba_path_guiding_torch.accel.bvh import build_bvh, to_device
    from mitsuba_path_guiding_torch.ops import intersect_twolevel as tl
    from mitsuba_path_guiding_torch.ops.intersect_blocklist import intersect_blocklist_sorted
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    new = {"twolevel_closest": tl._kernel_fn()}
    names = ["old"] + [os.path.relpath(src, ROOT) for src in sources[1:]]
    # the wrapper's table holds the entry point under "closest"
    versions = {"new": {"closest": new["twolevel_closest"]}}
    for k, (name, src) in enumerate(zip(names, sources)):
        lib = bind_old(build, src, f"intersect_twolevel_v{k}", new)
        versions[name] = {"closest": lib["twolevel_closest"]}
    turns = ["old", "new", *names[1:], *names[:0:-1], "new", "old"]
    tools = cs._interior_tools()
    p0, e1, e2 = tools.make_interior(cs.INTERIOR_TRIS)
    bt_i = tl.build_blocks(p0, e1, e2, device="cuda")
    bl = to_device(build_blocklist(p0, e1, e2, build_bvh(p0, e1, e2)), "cuda")
    cam, bounce = tools.interior_waves(p0, e1, e2, cs.INTERIOR_RAYS,
                                       lambda o, d, t: intersect_blocklist_sorted(bl, o, d, t),
                                       torch.device("cuda"))
    t_i = torch.full((cs.INTERIOR_RAYS,), 3.0e38, device="cuda")
    door = build_scene(door_room(), device="cuda")
    g = door.geo
    bt_d = tl.build_blocks(*(x.cpu().numpy() for x in (g.p0, g.e1, g.e2)), device="cuda")
    o, d, _ = cs.camera_rays(door, 1, 0, w=cs.DOOR_W, h=cs.DOOR_H)
    t_d = torch.full((o.shape[0],), 3.0e37, device="cuda")
    waves = {"interior_camera": (bt_i, cs.twolevel_inputs(bt_i, *cam, t_i)),
             "interior_bounce": (bt_i, cs.twolevel_inputs(bt_i, *bounce, t_i)),
             "door_room_camera": (bt_d, cs.twolevel_inputs(bt_d, o, d, t_d))}
    for label, (bt, inputs) in waves.items():
        def call():
            return tl.twolevel_cuda(bt, *inputs)
        outs = {}
        for v in ("new", *names):
            tl._FN.update(versions[v])
            outs[v] = call()
        tl._FN.update(versions["new"])
        torch.cuda.synchronize()
        for v in names:
            same_out = torch.equal(cs._bits(outs[v][0]), cs._bits(outs["new"][0]))
            same_work = torch.equal(outs[v][1], outs["new"][1])
            cs.check(same_out and same_work,
                     f"{label}: {v} and new differ on "
                     f"{int((cs._bits(outs[v][0]) != cs._bits(outs['new'][0])).any(dim=0).sum())} "
                     f"rays, work equal {same_work}")
        times = {v: [] for v in ("new", *names)}
        cold = {v: [] for v in ("new", *names)}
        for v in turns:
            tl._FN.update(versions[v])
            times[v].append(cs.cuda_ms(call))
        for v in turns:
            tl._FN.update(versions[v])
            cold[v].append(cs.cuda_ms(call, cold=True))
        tl._FN.update(versions["new"])
        b_ms, b_by, work = cs.twolevel_bound(inputs, outs["new"][1])
        per_tile = outs["new"][1][:, 1].double()
        work["opened_per_tile"] = {"mean": float(per_tile.mean()), "max": float(per_tile.max()),
                                   "p99": float(torch.quantile(per_tile, 0.99))}
        cs.emit({"call": label, "rays": inputs[0].shape[1], "tiles": inputs[2].shape[0],
                 "superblocks": inputs[2].shape[1], "equal": True, **work, "bound_ms": b_ms,
                 "bound_by": b_by, "hit_share": float((outs["new"][0][1] >= 0).float().mean()),
                 "ms": times, "ms_l2_cold": cold,
                 "speedup": statistics.mean(times["old"]) / statistics.mean(times["new"]),
                 "speedup_l2_cold": statistics.mean(cold["old"]) / statistics.mean(cold["new"])})
    cs.emit({"ptxas": {name: [ln.strip() for ln in open(
        os.path.join(build.BUILD_DIR, f"libintersect_twolevel_v{k}_old.log")).read().splitlines()
        if "registers" in ln or "spill" in ln] for k, name in enumerate(names)},
        "ptxas_new": cs.ptxas_report("intersect_twolevel")})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True,
                    choices=("pairs_mt", "pairs_plk", "intersect_tiled", "trace_fused",
                             "gather_rows_t", "intersect_bvh", "intersect_twolevel"))
    ap.add_argument("old_source")
    ap.add_argument("variants", nargs="*",
                    help="intersect_twolevel only: further versions timed in the same turns")
    args = ap.parse_args(argv)
    if args.variants and args.kernel != "intersect_twolevel":
        ap.error("only --kernel intersect_twolevel takes variant sources")
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mitsuba_path_guiding_torch.ops import build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    if args.kernel in ("pairs_mt", "pairs_plk"):
        ab_pairs(cs, build, args.old_source, args.kernel[len("pairs_"):])
    elif args.kernel == "intersect_tiled":
        ab_intersect_tiled(cs, build, args.old_source)
    elif args.kernel == "trace_fused":
        ab_trace_fused(cs, build, args.old_source, card)
    elif args.kernel == "gather_rows_t":
        ab_gather_rows_t(cs, build, args.old_source)
    elif args.kernel == "intersect_bvh":
        ab_intersect_bvh(cs, build, args.old_source, card)
    else:
        ab_intersect_twolevel(cs, build, [args.old_source, *args.variants])
    return 0


if __name__ == "__main__":
    sys.exit(main())
