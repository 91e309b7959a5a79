"""Reference image means of chip_smoke.py's irrcache_subsurface phase from
the JAX package.

Renders each run of chip_smoke.py's ``IRR_RUNS`` (the JAX package's
irradiance-cache and subsurface tests' configurations, on the scenes of
``subsurface_descs``) on the CPU at the test's seed and the next
``--seeds`` - 1, and prints one JSON line a run: the image mean at the
test's seed, the standard error of a render's mean (the spread of the
seeds' means), every seed's mean and the seconds taken (most of them the
run's compiles); the last line gives the tool's own run time.
chip_smoke.py holds the port's card renders of the same runs, at the
test's seed, to these means (``IRR_REFERENCE``), since the card has no
JAX.

  JAX_PLATFORMS=cpu python tools/irrcache_subsurface_reference_means.py [--runs NAME ...]
      [--seeds N]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import IRR_RUNS, subsurface_descs  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="*", default=list(IRR_RUNS), choices=list(IRR_RUNS))
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    from mitsuba_path_guiding_tpu.integrators.irrcache import render_irrcache
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_tpu.integrators.subsurface import render_subsurface
    from mitsuba_path_guiding_tpu.scene import scenes
    from mitsuba_path_guiding_tpu.scene.builder import build_scene

    descs = subsurface_descs(scenes)
    built = {}
    t_all = time.time()
    for run in args.runs:
        name, res, spp, depth, seed, kw = IRR_RUNS[run]
        t0 = time.time()
        if name not in built:
            built[name] = build_scene(descs[name])
        fn = render if run == "irrcache_pt" else (
            render_irrcache if run == "irrcache" else render_subsurface)
        imgs = [np.asarray(fn(built[name], RenderConfig(width=res, height=res, spp=spp,
                                                        max_depth=depth, seed=seed + k), **kw))
                for k in range(args.seeds)]
        means = [float(img.mean()) for img in imgs]
        print(json.dumps({
            "run": run, "scene": name, "resolution": f"{res}x{res}", "spp": spp,
            "max_depth": depth, "seed": seed, "kwargs": kw, "mean": means[0],
            "se": float(np.std(means, ddof=1)), "seed_means": means,
            "finite": bool(all(np.isfinite(img).all() for img in imgs)),
            "seconds": round(time.time() - t0, 1),
        }), flush=True)
    print(json.dumps({"tool_seconds": round(time.time() - t_all, 1)}), flush=True)


if __name__ == "__main__":
    main()
