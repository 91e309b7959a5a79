"""Reference image mean of the default door_room() from the JAX package.

Renders door_room() (244838 triangles) unguided through the JAX package's
BVH route (``use_bvh=True``, which shares no code with the pair and
blocklist intersectors) at depth 5 (rr_depth 5, NEE on) on the CPU, in
independent groups of different seeds, and prints the image mean and its
standard error over the groups.  chip_smoke.py holds the port's guided
progressive door_room render to this constant, since the card has no JAX.

  JAX_PLATFORMS=cpu python tools/door_room_reference_mean.py [--res 128] [--spp 4] [--groups 8]

The defaults give chip_smoke.py's constant (about 2 minutes on a CPU).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=4, help="samples per pixel of each group")
    ap.add_argument("--groups", type=int, default=8)
    args = ap.parse_args(argv)
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_tpu.scene.builder import build_scene
    from mitsuba_path_guiding_tpu.scene.scenes import door_room

    t0 = time.time()
    scene = build_scene(door_room())
    t_build = time.time() - t0
    means = []
    for group in range(args.groups):
        cfg = RenderConfig(width=args.res, height=args.res, spp=args.spp, max_depth=5,
                           rr_depth=5, seed=1000 + group, use_bvh=True,
                           samples_per_pass=1)
        means.append(float(np.asarray(render(scene, cfg)).mean()))
        print(json.dumps({"group": group, "mean": means[-1],
                          "seconds": round(time.time() - t0, 1)}), file=sys.stderr, flush=True)
    means = np.asarray(means)
    print(json.dumps({
        "scene": "door_room()", "triangles": int(scene.geo.p0.shape[0]),
        "resolution": f"{args.res}x{args.res}", "spp": args.spp * args.groups,
        "groups": args.groups, "max_depth": 5, "route": "JAX CPU, use_bvh=True, unguided",
        "mean": float(means.mean()),
        "stderr": float(means.std(ddof=1) / np.sqrt(len(means))),
        "group_means": means.tolist(),
        "build_seconds": round(t_build, 1), "seconds": round(time.time() - t0, 1),
    }))


if __name__ == "__main__":
    main()
