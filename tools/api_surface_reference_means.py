"""Reference image means of chip_smoke.py's api_surface phase from the JAX
package.

Renders each run of chip_smoke.py's ``API_RUNS`` (the Cornell box with
``RenderConfig.integrator="volpath"``, with ``use_bvh=True`` too, and the
guided progressive renderer with ``use_bvh=True``) on the CPU at seed 0
and the next ``--seeds`` - 1, and prints one JSON line a run: the image
mean at seed 0, the standard error of a render's mean (the spread of the
seeds' means), every seed's mean and the seconds taken (most of them the
run's compiles); the last line gives the tool's own run time.
chip_smoke.py holds the port's card renders of the same runs, at seed 0,
to these means (``API_REFERENCE``), since the card has no JAX.

  JAX_PLATFORMS=cpu python tools/api_surface_reference_means.py [--runs NAME ...] [--seeds N]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import API_RUNS, api_config, api_descs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="*", default=list(API_RUNS), choices=list(API_RUNS))
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    from mitsuba_path_guiding_tpu.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_tpu.scene import scenes
    from mitsuba_path_guiding_tpu.scene.builder import build_scene

    scene = build_scene(api_descs(scenes)["cornell"])
    t_all = time.time()
    for run in args.runs:
        t0 = time.time()
        progressive = API_RUNS[run][1]
        means = []
        for seed in range(args.seeds):
            if progressive:
                cfg = api_config(run, RenderConfig, ProgressiveConfig, seed=seed)
                img = ProgressiveRenderer(scene, cfg).render()
            else:
                img = render(scene, api_config(run, RenderConfig, seed=seed))
            img = np.asarray(img)
            assert np.isfinite(img).all(), run
            means.append(float(img.mean()))
        print(json.dumps({
            "run": run, "fields": API_RUNS[run][0], "progressive": progressive,
            "mean": means[0], "se": float(np.std(means, ddof=1)), "seed_means": means,
            "seconds": round(time.time() - t0, 1),
        }), flush=True)
    print(json.dumps({"tool_seconds": round(time.time() - t_all, 1)}), flush=True)


if __name__ == "__main__":
    main()
