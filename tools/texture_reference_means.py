"""Reference image means of chip_smoke.py's texture renders from the JAX
package.

Renders the scenes of chip_smoke.py's ``texture_descs`` (the checkerboard
Cornell box, the bitmaps inline under ``scale`` and from a .pfm, the
normal- and bump-mapped walls, the wireframe box with the
curvature-coloured sphere, the irawan back wall, the irawan plane, the
checker floor and the envmap read from a .pfm) unguided at depth 5, rr_depth 5, NEE on, on the
CPU in independent groups of different seeds, and prints one JSON line a
scene: the image mean, its standard error over the groups and the seconds
taken; the last line gives the tool's own run time.  The floor renders at
256x256, the resolution whose pixel cone chip_smoke's render() filters
its mip levels by; the others at ``--res``.  chip_smoke.py's phase
"textures" holds the port's renders of these scenes to these constants
(``TEXTURE_REFERENCE``), since the card has no JAX.  The scenes' files
are written under build/chip_smoke/ in the checkout.

  JAX_PLATFORMS=cpu python tools/texture_reference_means.py [--res 128] [--spp 8] [--groups 8] [--scenes NAME ...]

The defaults (128x128, 8 groups of 8 spp) give chip_smoke.py's constants.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import W, texture_descs, texture_dir  # noqa: E402

SCENES = ("cornell_checker", "cornell_bitmap_scale", "cornell_bitmap_pfm", "cornell_bump",
          "cornell_vcol_wire", "cornell_cloth", "cloth", "floor_cone", "envmap_file")
FULL_RES = ("floor_cone",)


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

    descs = texture_descs(scenes, texture_dir())
    t_all = time.time()
    for name in args.scenes:
        t0 = time.time()
        res = W if name in FULL_RES else args.res
        scene = build_scene(descs[name])
        means = []
        for group in range(args.groups):
            cfg = RenderConfig(width=res, height=res, spp=args.spp, max_depth=5, rr_depth=5,
                               seed=1000 + group)
            means.append(float(np.asarray(render(scene, cfg)).mean()))
        means = np.asarray(means)
        print(json.dumps({
            "scene": name, "resolution": f"{res}x{res}", "spp": args.spp * args.groups,
            "max_depth": 5, "mean": float(means.mean()),
            "stderr": float(means.std(ddof=1) / np.sqrt(len(means))),
            "group_means": means.tolist(), "seconds": round(time.time() - t0, 1),
        }), flush=True)
    print(json.dumps({"tool_seconds": round(time.time() - t_all, 1)}), flush=True)


if __name__ == "__main__":
    main()
