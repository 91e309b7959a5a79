#!/usr/bin/env python3
"""The MT pair-tile kernel or the fused path kernel against another
version of its source, in one process on one NVIDIA card.

  python3 tools/kernel_ab.py --kernel pairs_mt OLD/csrc/intersect_pairs.cu
  python3 tools/kernel_ab.py --kernel trace_fused OLD/csrc/fused_path.cu

OLD is another version of the source (with its ``device_math.cuh``
beside it), for example a ``git archive`` of an earlier commit unpacked
into a directory that .gitignore lists.  It is built with the port's nvcc
flags and bound in place of the current kernel's C entry points for the
"old" turns; both versions run through the same wrapper.

  - pairs_mt, on door_room() (244838 triangles, 512x512): the sorted pairs
    of chip_smoke's timed camera wave (the second 131072-ray wave) and of
    a first bounce of that wave, closest hit and any-hit: the two
    versions' outputs torch.equal, then CUDA-event medians of 7 in turns
    old, new, new, old; then the guided door_room render through the pair
    route (160 MT launches), old, new, new, old, with the MT kernel's time
    summed over its launches (CUDA events around every launch).
  - trace_fused, on cornell_box() with the grid of chip_smoke's guided
    progressive render: the 524288-lane frozen wave of chip_smoke's timings,
    guided and unguided: rows 0:16 torch.equal on every lane, then medians
    of 7, old, new, new, old; then the frozen-cache render's 16 waves, old,
    new, new, old, in seconds, Mrays/s and the kernel's summed time.

The new fused kernel keeps its ray counter in a __device__ variable of its
own library and zeroes it in its C entry point, so both versions take the
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
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(target)
    old = {}
    for key, f in entries.items():
        g = getattr(lib, key)
        g.argtypes, g.restype = f.argtypes, f.restype
        old[key] = g
    return old


def in_turns(cs, fn, versions, fns):
    """fn() timed in turns old, new, new, old with fns (the wrapper's
    entry-point table) holding each version's entry points in turn."""
    times = {"old": [], "new": []}
    for v in ("old", "new", "new", "old"):
        fns.update(versions[v])
        times[v].append(cs.cuda_ms(fn))
    fns.update(versions["new"])
    return times


def both(versions, fns, fn):
    """fn()'s result under each version: {"old": ..., "new": ...}."""
    out = {}
    for v in ("old", "new"):
        fns.update(versions[v])
        out[v] = fn()
    fns.update(versions["new"])
    return out


def ab_pairs_mt(cs, build, source):
    import torch

    from mitsuba_path_guiding_torch.ops import intersect_pairs as ip
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    new = {f"pair_mt_{k}": ip._kernel_fn("mt", k == "any") for k in ("closest", "any")}
    versions = {"new": new, "old": bind_old(build, source, "intersect_pairs", new)}
    door = build_scene(door_room(), device="cuda")
    o, d, _ = cs.camera_rays(door, 1, 9, w=cs.DOOR_W, h=cs.DOOR_H)
    o, d = o[cs.DOOR_WAVE:2 * cs.DOOR_WAVE], d[cs.DOOR_WAVE:2 * cs.DOOR_WAVE]
    tmax = torch.full((cs.DOOR_WAVE,), 3.0e37, device=o.device)
    waves = {"camera_wave": (o, d, tmax), "first_bounce": cs.first_bounce(door, o, d, tmax, 4)}
    for label, (oo, dd, tt) in waves.items():
        pdata, tile_block = cs._pair_set(door, oo, dd, tt)
        work = cs.mt_tile_work(door.pairs, pdata, tile_block)
        for any_hit in (False, True):
            def call():
                return ip.mt_tiles(door.pairs.tri_rows, tile_block, pdata, any_hit)
            outs = both(versions, ip._FN, call)
            torch.cuda.synchronize()
            cs.check(torch.equal(outs["old"].view(torch.int32), outs["new"].view(torch.int32)),
                     f"{label} any_hit={any_hit}: old and new MT kernels differ")
            times = in_turns(cs, call, versions, ip._FN)
            cs.emit({"call": label, "any_hit": any_hit, "pairs": pdata.shape[1],
                     "live_tiles": int((tile_block >= 0).sum()), **work,
                     "tests_run_before": int((tile_block >= 0).sum()) * ip.TILE * ip.LEAF,
                     "equal": True, "old_ms": times["old"], "new_ms": times["new"],
                     "speedup": statistics.mean(times["old"]) / statistics.mean(times["new"])})
    for v in ("old", "new", "new", "old"):
        ip._FN.update(versions[v])
        rec, t = cs.mt_kernel_time(
            lambda: cs.phase_door_progressive(door, cs.DOOR_SPP, "door_room_progressive"))
        cs.emit({"render": "pair", "version": v, "seconds": rec["seconds"],
                 "mrays_per_s": rec["mrays_per_s"], "mean": rec["mean"], **t})
    ip._FN.update(versions["new"])


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", required=True, choices=("pairs_mt", "trace_fused"))
    ap.add_argument("old_source")
    args = ap.parse_args(argv)
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
    if args.kernel == "pairs_mt":
        ab_pairs_mt(cs, build, args.old_source)
    else:
        ab_trace_fused(cs, build, args.old_source, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
