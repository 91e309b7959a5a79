"""Command-line renderer of the port (the reference's render.py for its
built-in scenes: ``cornell``, ``furnace`` (a diffuse sphere in a constant
environment, the white-furnace check), ``veach`` (Veach's MIS plates) and
``volbox`` (the Cornell box filled with a homogeneous scattering medium,
rendered by the volumetric tracer with guided distance sampling).

  python -m mitsuba_path_guiding_torch.render cornell -o out.exr
  python -m mitsuba_path_guiding_torch.render veach -o out.npy -s 64 -G --device cpu
  python -m mitsuba_path_guiding_torch.render volbox -o vol.npy -r 32x32 -s 4 --device cpu

  -o FILE      output (exr/pfm/png/npy; default <scene>.exr)
  -s N         samples per pixel (default 16)
  -d N         max path depth (default 5)
  -r WxH       resolution (default 256x256)
  -g / -G      enable / disable path guiding (default: on)
  -p N         samples per progression (default 4)
  -t SEC       time budget
  --seed N     random seed
  --device D   cuda (default) or cpu

The default is the guided progressive render on the card; without a card
it raises unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mitsuba_path_guiding_torch.render")
    ap.add_argument("scene", choices=["cornell", "furnace", "veach", "volbox"],
                    help="built-in scene")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-s", "--spp", type=int, default=16)
    ap.add_argument("-d", "--depth", type=int, default=5)
    ap.add_argument("-r", "--resolution", default="256x256")
    ap.add_argument("-g", "--guide", dest="guide", action="store_true", default=True)
    ap.add_argument("-G", "--no-guide", dest="guide", action="store_false")
    ap.add_argument("-p", "--pass-size", type=int, default=4)
    ap.add_argument("-t", "--time-budget", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    def log(*a):
        print(*a, file=sys.stderr, flush=True)

    from mitsuba_path_guiding_torch.film.film import write_image
    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.scene import scenes as builtin
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    builtins = {"cornell": builtin.cornell_box, "furnace": builtin.furnace,
                "veach": builtin.veach_mis, "volbox": builtin.volumetric_box}

    width, height = (int(x) for x in args.resolution.lower().split("x"))
    out = args.output or f"{args.scene}.exr"
    log(f"scene: {args.scene}  {width}x{height}@{args.spp}spp depth={args.depth} "
        f"guiding={'on' if args.guide else 'off'}")
    scene = build_scene(builtins[args.scene](), device=args.device)
    log(f"scene compiled on {scene.geo.p0.device}: {int(scene.geo.p0.shape[0])} triangles")
    rcfg = RenderConfig(width=width, height=height, spp=0, max_depth=args.depth,
                        rr_depth=5, seed=args.seed)
    n_prog = max(1, (args.spp + args.pass_size - 1) // args.pass_size)
    pcfg = ProgressiveConfig(render=rcfg, samples_per_progression=min(args.pass_size, args.spp),
                             n_progressions=n_prog, max_seconds=args.time_budget,
                             guiding=args.guide)
    renderer = ProgressiveRenderer(scene, pcfg)
    t0 = time.time()
    img = renderer.render().cpu().numpy()
    log(f"render time: {time.time() - t0:.1f}s")
    log(renderer.stats.report())
    write_image(out, img)
    log(f"wrote {out}  (mean {img.mean():.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
