"""Reference image means of chip_smoke.py's integrators phase from the JAX
package.

Renders each scene of chip_smoke.py's ``integrator_descs`` with each of
its integrators in ``INTEGRATOR_RUNS`` (the unguided path tracer
"path", "direct", "ao", "ptracer", "bdpt" and "vpl" with 256 VPL paths,
each at the JAX package's defaults and the scene's depth, rr_depth 5) on
the CPU in independent groups of different seeds, and prints one JSON
line a (scene, integrator): the image mean, its standard error over the
groups and the seconds taken; the last line gives the tool's own run
time.  chip_smoke.py's phase "integrators" holds the port's renders to
these constants (``INTEGRATOR_REFERENCE``), since the card has no JAX.

  JAX_PLATFORMS=cpu python tools/integrator_reference_means.py [--res 64] [--spp 4] [--groups 12] [--runs SCENE/INTEGRATOR ...]

The defaults give chip_smoke.py's constants.  An image mean does not
depend on the resolution in expectation, so the CPU renders at --res.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import INTEGRATOR_RUNS, integrator_descs  # noqa: E402

RUNS = tuple(f"{s}/{i}" for s, (_, names) in INTEGRATOR_RUNS.items() for i in names)


def renderers():
    from mitsuba_path_guiding_tpu.integrators import aux_integrators, bdpt, ptracer, vpl
    from mitsuba_path_guiding_tpu.integrators.render import render

    return {"path": render, "direct": aux_integrators.render_direct,
            "ao": aux_integrators.render_ao, "ptracer": ptracer.render_ptracer,
            "bdpt": bdpt.render_bdpt, "vpl": vpl.render_vpl}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--spp", type=int, default=4, help="samples per pixel of each group")
    ap.add_argument("--groups", type=int, default=12)
    ap.add_argument("--runs", nargs="*", default=list(RUNS), choices=RUNS)
    args = ap.parse_args(argv)
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig
    from mitsuba_path_guiding_tpu.scene import scenes
    from mitsuba_path_guiding_tpu.scene.builder import build_scene

    descs = integrator_descs(scenes)
    funcs = renderers()
    built = {}
    t_all = time.time()
    for run in args.runs:
        name, integrator = run.split("/")
        depth = INTEGRATOR_RUNS[name][0]
        t0 = time.time()
        if name not in built:
            built[name] = build_scene(descs[name])
        means = []
        for group in range(args.groups):
            cfg = RenderConfig(width=args.res, height=args.res, spp=args.spp, max_depth=depth,
                               rr_depth=5, seed=1000 + group)
            means.append(float(np.asarray(funcs[integrator](built[name], cfg)).mean()))
        means = np.asarray(means)
        print(json.dumps({
            "scene": name, "integrator": integrator, "resolution": f"{args.res}x{args.res}",
            "spp": args.spp * args.groups, "max_depth": depth, "mean": float(means.mean()),
            "stderr": float(means.std(ddof=1) / np.sqrt(len(means))),
            "group_means": means.tolist(), "seconds": round(time.time() - t0, 1),
        }), flush=True)
    print(json.dumps({"tool_seconds": round(time.time() - t_all, 1)}), flush=True)


if __name__ == "__main__":
    main()
