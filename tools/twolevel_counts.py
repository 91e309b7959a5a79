#!/usr/bin/env python3
"""What the two-level kernel's walk does on chip_smoke's three waves,
counted on the CPU: the kernel's per-ray steps (csrc/device_math.cuh
pg_tl_*) run by g++ behind csrc/host_shim.cpp host_twolevel_tile, tile by
tile, in the kernel's order and with its warp votes.

  JAX_PLATFORMS=cpu python3 tools/twolevel_counts.py [--tiles N]

The waves: the interior scene's sorted camera wave (524288 rays) and the
bounce wave from its hits (tools/profile_blocklist_torch.py, the hits
taken from the camera wave's own walk), and door_room()'s sorted camera
wave at 512x512 (chip_smoke.py phase_door_twolevel_bvh).  Each wave
prints one JSON line: candidates and those that did not open, the warps'
record tests and the shares that escaped the division-free reject and
that passed 0 <= u <= 1, the work counts of the tiles walked, and over
those tiles the blocks opened a tile (mean, max, the sums over eighths of
the wave in index order) and how closely the superblocks a tile walks
follow them.  --tiles N walks N tiles spread over each wave (default:
every tile of the camera waves, 64 of the bounce wave, whose densest
tiles take minutes).  Counts only: no time.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "mitsuba_path_guiding_torch", "csrc")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))


def host_lib(tmp):
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("twolevel_counts: g++ is needed")
    out = os.path.join(tmp, "libhostshim.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-I", CSRC,
                    "-o", out, os.path.join(CSRC, "host_shim.cpp")], check=True)
    return ctypes.CDLL(out)


def walk(lib, bt, o, d, tmax, tiles=None):
    """Sort the rays as intersect_blocks_sorted does and walk the tiles.
    Returns (out (4, n) in ray order, work (tiles, 4), stats (5,), the
    tiles walked, walked superblocks of every tile)."""
    import torch

    from mitsuba_path_guiding_torch.ops import intersect_twolevel as tl

    p = lambda a: a.ctypes.data_as(ctypes.c_void_p)  # noqa: E731
    n = o.shape[0]
    perm = torch.argsort(tl._ray_sort_keys(bt, o, d), stable=True)
    o, d, tmax = o[perm], d[perm], tmax[perm]
    ray, tmax_p = tl._pad_rays(o, d, tmax)
    mask, order = tl.superblock_mask(bt, o, d, tmax)
    a = [np.ascontiguousarray(x.numpy()) for x in (mask, order, bt.blk_lo, bt.blk_hi, ray, tmax_p,
                                                   bt.tri_pack)]
    npad = ray.shape[1]
    nt = npad // tl.RAY_TILE
    out = np.zeros((4, npad), np.float32)
    work = np.zeros((nt, 4), np.int64)
    stats = np.zeros(5, np.int64)
    sel = np.arange(nt) if tiles is None else np.unique(np.linspace(0, nt - 1, tiles).round()
                                                        .astype(np.int64))
    for t in sel:
        lib.host_twolevel_tile(p(a[0]), p(a[1]), ctypes.c_int(a[1].shape[0]), p(a[2]), p(a[3]),
                               ctypes.c_int(a[2].shape[1]), p(a[4]), p(a[5]), ctypes.c_int(npad),
                               p(a[6]), ctypes.c_int(int(t)), p(out), p(work), p(stats))
    back = np.empty(n, np.int64)
    back[perm.numpy()] = np.arange(n)
    return out[:, back], work[sel], stats, sel, mask.sum(dim=1).numpy()


def report(wave, work, stats, sel, walked):
    opened = work[:, 1]
    emit = {"wave": wave, "tiles_walked": int(sel.size), "tiles": int(walked.size),
            "candidates": int(stats[0]), "not_opened": int(stats[1]),
            "not_opened_share": float(stats[1] / max(stats[0], 1)),
            "warp_record_tests": int(stats[2]),
            "escaped_reject_share": float(stats[3] / max(stats[2], 1)),
            "passed_u_share": float(stats[4] / max(stats[2], 1)),
            "work": [int(x) for x in work.sum(axis=0)],
            "opened_per_tile_mean": float(opened.mean()), "opened_per_tile_max": int(opened.max()),
            "opened_by_index_eighth": [int(x.sum()) for x in np.array_split(opened, 8)],
            "walked_max_over_mean": float(walked.max() / max(walked.mean(), 1e-9)),
            "walked_opened_correlation": float(np.corrcoef(walked[sel], opened)[0, 1])}
    print(json.dumps(emit), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    import chip_smoke as cs
    import profile_blocklist_torch as pb
    from mitsuba_path_guiding_torch.ops import intersect_twolevel as tl
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    with tempfile.TemporaryDirectory() as tmp:
        lib = host_lib(tmp)
        p0, e1, e2 = pb.make_interior(cs.INTERIOR_TRIS)
        bt = tl.build_blocks(p0, e1, e2)
        o, d = (torch.from_numpy(x) for x in pb.camera_rays(cs.INTERIOR_RAYS, seed=0))
        tmax = torch.full((cs.INTERIOR_RAYS,), 3.0e38)
        out, work, stats, sel, walked = walk(lib, bt, o, d, tmax, args.tiles)
        report("interior_camera", work, stats, sel, walked)
        if args.tiles is not None:  # the bounce rays start at every camera hit
            out = walk(lib, bt, o, d, tmax)[0]
        t = np.where(out[1] >= 0, out[0], 1.0)
        ob, db = pb.bounce_rays(p0, e1, e2, o.numpy(), d.numpy(), t,
                                np.maximum(out[1].astype(np.int64), 0), seed=1)
        res = walk(lib, bt, torch.from_numpy(ob), torch.from_numpy(db), tmax,
                   64 if args.tiles is None else args.tiles)
        report("interior_bounce", *res[1:])
        door = build_scene(door_room(), device="cpu")
        g = door.geo
        bt = tl.build_blocks(g.p0.numpy(), g.e1.numpy(), g.e2.numpy())
        o, d, _ = cs.camera_rays(door, 1, 0, w=cs.DOOR_W, h=cs.DOOR_H)
        res = walk(lib, bt, o, d, torch.full((o.shape[0],), 3.0e37), args.tiles)
        report("door_room_camera", *res[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
