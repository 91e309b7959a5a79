"""Reference image means of chip_smoke.py's chains phase from the JAX
package.

Renders each run of chip_smoke.py's ``CHAIN_RUNS`` (the JAX package's
MLT, PSSMLT, ERPT, SPPM and photon-mapper tests' configurations, on the
scenes of ``chain_descs``) once on the CPU at the test's seed, and prints
one JSON line a run: the image mean and the seconds taken (most of them
the run's compiles); the last line gives the tool's own run time.
chip_smoke.py's phase "chains" holds the port's card renders of the same
runs to these means (``CHAIN_REFERENCE``), since the card has no JAX.
The runs of ``CHAIN_NO_REFERENCE`` are left out.

  JAX_PLATFORMS=cpu python tools/chain_reference_means.py [--runs NAME ...]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import CHAIN_NO_REFERENCE, CHAIN_RUNS, chain_descs  # noqa: E402

RUNS = tuple(k for k in CHAIN_RUNS if k not in CHAIN_NO_REFERENCE)


def renderers():
    from mitsuba_path_guiding_tpu.integrators import erpt, mlt, photonmapper, pssmlt, sppm

    return {"mlt": mlt.render_mlt, "pssmlt": pssmlt.render_pssmlt, "erpt": erpt.render_erpt,
            "sppm": sppm.render_sppm, "photonmapper": photonmapper.render_photonmapper}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="*", default=list(RUNS), choices=RUNS)
    args = ap.parse_args(argv)
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig
    from mitsuba_path_guiding_tpu.scene import scenes
    from mitsuba_path_guiding_tpu.scene.builder import build_scene

    descs = chain_descs(scenes)
    funcs = renderers()
    built = {}
    t_all = time.time()
    for run in args.runs:
        name, integrator, res, spp, depth, seed, kw = CHAIN_RUNS[run]
        t0 = time.time()
        if name not in built:
            built[name] = build_scene(descs[name])
        cfg = RenderConfig(width=res, height=res, spp=spp, max_depth=depth, rr_depth=5,
                           seed=seed)
        img = np.asarray(funcs[integrator](built[name], cfg, **kw))
        print(json.dumps({
            "run": run, "scene": name, "integrator": integrator, "resolution": f"{res}x{res}",
            "spp": spp, "max_depth": depth, "seed": seed, "kwargs": kw,
            "mean": float(img.mean()), "finite": bool(np.isfinite(img).all()),
            "seconds": round(time.time() - t0, 1),
        }), flush=True)
    print(json.dumps({"tool_seconds": round(time.time() - t_all, 1)}), flush=True)


if __name__ == "__main__":
    main()
