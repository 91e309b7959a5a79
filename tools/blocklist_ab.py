#!/usr/bin/env python3
"""The blocklist kernel against another version of its source, in one
process on one NVIDIA card.

  python3 tools/blocklist_ab.py OLD_SOURCE

OLD_SOURCE is another version of ``csrc/intersect_blocklist.cu`` (with its
``device_math.cuh`` beside it), for example a ``git archive`` of an
earlier commit unpacked into a directory that .gitignore lists.  It is
built with the port's nvcc flags and bound in place of the current
kernel's C entry points for the "old" turns; both versions run through
the same wrapper, ``ops/intersect_blocklist.blocklist_cuda``.  On
door_room() (244838 triangles, 512x512) and the interior scene:

  - on every call of chip_smoke.blocklist_calls (the pair route's two
    fallback calls, the sorted bounce and camera waves) and on the sorted
    camera and bounce waves of the interior scene (2048 tiles), closest
    hit and any-hit: t, prim and the work counts of the two versions
    equal, then CUDA-event medians of 7 in turns old, new, new, old;
  - the guided door_room renders through the pair route and through the
    sorted blocklist, in turns old, new, new, old, each with the
    blocklist's kernel time summed over its launches (CUDA events around
    every launch) and its wall time.

Each result is one JSON line; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def interior_calls(cs, ib):
    """The kernel's inputs on the sorted route of the interior scene of
    tools/profile_blocklist_torch.py: its camera and bounce waves of
    524288 rays (2048 tiles), sorted as intersect_blocklist_sorted sorts
    them."""
    import torch

    from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
    from mitsuba_path_guiding_torch.accel.bvh import build_bvh, to_device

    tools = cs._interior_tools()
    p0, e1, e2 = tools.make_interior(cs.INTERIOR_TRIS)
    bl = to_device(build_blocklist(p0, e1, e2, build_bvh(p0, e1, e2)), "cuda")
    tmax = torch.full((cs.INTERIOR_RAYS,), 3.0e38, device="cuda")
    waves = tools.interior_waves(p0, e1, e2, cs.INTERIOR_RAYS,
                                 lambda o, d, t: ib.intersect_blocklist_sorted(bl, o, d, t),
                                 torch.device("cuda"))
    calls = {}
    for label, (o, d) in zip(("interior_camera_wave", "interior_bounce_wave"), waves):
        perm = torch.argsort(ib._ray_sort_keys(bl, o, d), stable=True)
        o_p, d_p, t_p, npad = ib._pad_rays(o[perm], d[perm], tmax)
        k = ib.cand_width(npad, bl.sb_lo.shape[0])
        cand, cnt = ib.candidate_superblocks(bl.sb_lo, bl.sb_hi, o_p, d_p, t_p, k)
        calls[label] = ((bl, o_p, d_p, t_p, cand, cnt),
                        {"rays": npad, "k": k, "overflow_tiles": int((cnt > k).sum())})
    return calls


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old_source")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("blocklist_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from mitsuba_path_guiding_torch.ops import build
    from mitsuba_path_guiding_torch.ops import intersect_blocklist as ib
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    target = os.path.join(build.BUILD_DIR, "libintersect_blocklist_old.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", target, args.old_source],
                   check=True, capture_output=True)
    old_lib = ctypes.CDLL(target)
    versions = {"new": {k: ib._kernel_fn(k == "any") for k in ("closest", "any")}, "old": {}}
    for k, f in versions["new"].items():
        g = getattr(old_lib, f"blocklist_{k}")
        g.argtypes, g.restype = f.argtypes, f.restype
        versions["old"][k] = g

    door = build_scene(door_room(), device="cuda")
    calls = cs.blocklist_calls(door, sorted_camera=True)
    calls.update(interior_calls(cs, ib))
    for label, (call_args, info) in calls.items():
        for any_hit in (False, True):
            outs = {}
            for v, fns in versions.items():
                ib._FN.update(fns)
                outs[v] = ib.blocklist_cuda(*call_args, any_hit)
            torch.cuda.synchronize()
            (new, new_w), (old, old_w) = outs["new"], outs["old"]
            cs.check(torch.equal(new[0:2], old[0:2]) and torch.equal(new_w, old_w),
                     f"{label} any_hit={any_hit}: old and new kernels differ")
            times = {"old": [], "new": []}
            for v in ("old", "new", "new", "old"):
                ib._FN.update(versions[v])
                times[v].append(cs.cuda_ms(lambda: ib.blocklist_cuda(*call_args, any_hit)))
            old_ms, new_ms = statistics.mean(times["old"]), statistics.mean(times["new"])
            cs.emit({"call": label, "any_hit": any_hit, **info,
                     "geometry": ib.launch_shape(info["rays"], any_hit),
                     "work": new_w.sum(dim=0).tolist(), "old_ms": times["old"],
                     "new_ms": times["new"], "speedup": old_ms / new_ms})

    renders = {
        "pair": lambda: cs.phase_door_progressive(door, cs.DOOR_SPP, "door_room_progressive"),
        "sorted": lambda: cs.phase_door_progressive(door._replace(pairs=None), cs.DOOR_SORTED_SPP,
                                                    "door_room_sorted_blocklist")}
    for route, fn in renders.items():
        for v in ("old", "new", "new", "old"):
            ib._FN.update(versions[v])
            rec, t = cs.blocklist_kernel_time(fn)
            cs.emit({"render": route, "version": v, "seconds": rec["seconds"],
                     "mrays_per_s": rec["mrays_per_s"], "mean": rec["mean"], **t})
    ib._FN.update(versions["new"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
