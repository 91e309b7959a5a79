"""Reference image means of chip_smoke.py's volume renders from the JAX
package.

Renders the scenes of chip_smoke.py's ``volume_descs`` (the CLI's volbox,
the grid box, and the volbox with the Rayleigh, Kajiya-Kay, microflake
and mixture phases) unguided at depth 5, and the volbox at depth 8 (as
``volbox_d8``, bench.py's volumetric recipe), rr_depth equal to the
depth, NEE on, on the CPU in independent groups of different seeds, and
prints one JSON line a scene: the image mean, its standard error over the
groups and the seconds taken; the last line gives the tool's own run
time.  chip_smoke.py's phase "volumes" holds the port's renders of these
scenes to these constants (``VOLUME_REFERENCE``), since the card has no
JAX.

  JAX_PLATFORMS=cpu python tools/volume_reference_means.py [--res 128] [--spp 8] [--groups 8] [--scenes NAME ...]

The defaults (128x128, 8 groups of 8 spp) give chip_smoke.py's constants.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import VOL_BENCH_DEPTH, VOL_PHASES, volume_descs  # noqa: E402

SCENES = ("volbox", "grid_box") + tuple(f"volbox_{k}" for k in VOL_PHASES) + ("volbox_d8",)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8, help="samples per pixel of each group")
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--scenes", nargs="*", default=list(SCENES), choices=SCENES)
    args = ap.parse_args(argv)
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_tpu.scene import scenes
    from mitsuba_path_guiding_tpu.scene.builder import build_scene

    descs = volume_descs(scenes)
    t_all = time.time()
    for name in args.scenes:
        t0 = time.time()
        depth = VOL_BENCH_DEPTH if name == "volbox_d8" else 5
        scene = build_scene(descs["volbox" if name == "volbox_d8" else name])
        means = []
        for group in range(args.groups):
            cfg = RenderConfig(width=args.res, height=args.res, spp=args.spp, max_depth=depth,
                               rr_depth=depth, seed=1000 + group)
            means.append(float(np.asarray(render(scene, cfg)).mean()))
        means = np.asarray(means)
        print(json.dumps({
            "scene": name, "resolution": f"{args.res}x{args.res}",
            "spp": args.spp * args.groups, "max_depth": depth,
            "mean": float(means.mean()),
            "stderr": float(means.std(ddof=1) / np.sqrt(len(means))),
            "group_means": means.tolist(), "seconds": round(time.time() - t0, 1),
        }), flush=True)
    print(json.dumps({"tool_seconds": round(time.time() - t_all, 1)}), flush=True)


if __name__ == "__main__":
    main()
