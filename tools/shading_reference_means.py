"""Reference image means of the shading-breadth and vocabulary scenes
from the JAX package.

Renders ``cornell_box(box_material="glass")``, ``cornell_box(box_material=
"mirror")``, ``veach_mis()`` and the scenes of chip_smoke.py's
``vocabulary_descs`` (the coated, rough-coated and HK Cornell boxes, the
sky, sun and sunsky planes, the Cornell box through the orthographic,
spherical, thin-lens and telecentric sensors) unguided at depth 5
(rr_depth 5, NEE on) on the CPU, in independent groups of different
seeds, and prints one JSON line a scene: the image mean, its standard
error over the groups and the seconds taken.  chip_smoke.py (phases
"shading" and "vocabulary") holds the port's renders of these scenes to
these constants, since the card has no JAX.

  JAX_PLATFORMS=cpu python tools/shading_reference_means.py [--res 128] [--spp 8] [--groups 8] [--scenes NAME ...]

The defaults (128x128, 8 groups of 8 spp) give chip_smoke.py's constants.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import VOCAB_BSDFS, VOCAB_SENSORS, vocabulary_descs  # noqa: E402

VOCABULARY = (tuple(VOCAB_BSDFS) + ("sky", "sun", "sunsky")
              + tuple(f"cornell_{k}" for k in VOCAB_SENSORS))
SCENES = ("cornell_glass", "cornell_mirror", "veach_mis") + VOCABULARY


def describe(name):
    from mitsuba_path_guiding_tpu.scene import scenes

    if name == "veach_mis":
        return scenes.veach_mis()
    if name in VOCABULARY:
        return vocabulary_descs(scenes)[name]
    return scenes.cornell_box(box_material=name.split("_")[1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=8, help="samples per pixel of each group")
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--scenes", nargs="*", default=list(SCENES), choices=SCENES)
    args = ap.parse_args(argv)
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_tpu.scene.builder import build_scene

    for name in args.scenes:
        t0 = time.time()
        scene = build_scene(describe(name))
        means = []
        for group in range(args.groups):
            cfg = RenderConfig(width=args.res, height=args.res, spp=args.spp, max_depth=5,
                               rr_depth=5, seed=1000 + group)
            means.append(float(np.asarray(render(scene, cfg)).mean()))
        means = np.asarray(means)
        print(json.dumps({
            "scene": name, "resolution": f"{args.res}x{args.res}",
            "spp": args.spp * args.groups, "max_depth": 5,
            "mean": float(means.mean()),
            "stderr": float(means.std(ddof=1) / np.sqrt(len(means))),
            "group_means": means.tolist(), "seconds": round(time.time() - t0, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
