"""Command-line renderer of the port (the reference's render.py for its
built-in scenes: ``cornell``, ``furnace`` (a diffuse sphere in a constant
environment, the white-furnace check), ``veach`` (Veach's MIS plates) and
``volbox`` (the Cornell box filled with a homogeneous scattering medium,
rendered by the volumetric tracer with guided distance sampling).

  python -m mitsuba_path_guiding_torch.render cornell -o out.exr
  python -m mitsuba_path_guiding_torch.render veach -o out.npy -s 64 -G --device cpu
  python -m mitsuba_path_guiding_torch.render volbox -o vol.npy -r 32x32 -s 4 --device cpu
  python -m mitsuba_path_guiding_torch.render cornell -o c.exr -s 16 --denoise --aovs
  python -m mitsuba_path_guiding_torch.render cornell -I bdpt -o b.exr
  python -m mitsuba_path_guiding_torch.render cornell -I sppm -o s.npy -r 32x32 -s 1 --device cpu

  -o FILE      output (exr/pfm/png/npy; default <scene>.exr)
  -s N         samples per pixel (default 16)
  -d N         max path depth (default 5)
  -r WxH       resolution (default 256x256)
  -g / -G      enable / disable path guiding (default: on)
  -p N         samples per progression (default 4)
  -t SEC       time budget
  -I NAME      integrator: guided (default; the progressive guided path
               tracer), path, direct, ao, ptracer, bdpt, vpl, pssmlt, mlt
               and erpt (-s counts mutations a pixel, seed paths for
               erpt), sppm (8 passes of 131072 photons) or photonmapper
               (131072 photons, -s camera samples with a final gather)
  --seed N     random seed
  --denoise    denoise the image (the neural denoiser over 4 spp of
               albedo, normal and depth feature buffers)
  --aovs       also write the feature buffers, <output>_{albedo,normal,depth}.npy
  --device D   cuda (default) or cpu

The default is the guided progressive render on the card; without a card
it raises unless ``--device cpu`` is given.  The other integrators render
once at the given spp with the JAX CLI's defaults (``--denoise`` and
``--aovs`` need ``guided``).
"""
from __future__ import annotations

import argparse
import sys
import time

INTEGRATORS = ("guided", "path", "bdpt", "pssmlt", "mlt", "erpt", "sppm", "vpl", "ptracer",
               "photonmapper", "direct", "ao")


def render_once(name: str, scene, cfg):
    """The image of a one-shot integrator (every ``-I`` choice but
    ``guided``)."""
    if name == "path":
        from mitsuba_path_guiding_torch.integrators.render import render
        return render(scene, cfg)
    if name == "bdpt":
        from mitsuba_path_guiding_torch.integrators.bdpt import render_bdpt
        return render_bdpt(scene, cfg)
    if name == "pssmlt":
        from mitsuba_path_guiding_torch.integrators.pssmlt import render_pssmlt
        return render_pssmlt(scene, cfg)
    if name == "mlt":
        from mitsuba_path_guiding_torch.integrators.mlt import render_mlt
        return render_mlt(scene, cfg)
    if name == "erpt":
        from mitsuba_path_guiding_torch.integrators.erpt import render_erpt
        return render_erpt(scene, cfg)
    if name == "sppm":
        from mitsuba_path_guiding_torch.integrators.sppm import render_sppm
        return render_sppm(scene, cfg)
    if name == "photonmapper":
        from mitsuba_path_guiding_torch.integrators.photonmapper import render_photonmapper
        return render_photonmapper(scene, cfg)
    if name == "vpl":
        from mitsuba_path_guiding_torch.integrators.vpl import render_vpl
        return render_vpl(scene, cfg)
    if name == "ptracer":
        from mitsuba_path_guiding_torch.integrators.ptracer import render_ptracer
        return render_ptracer(scene, cfg)
    if name == "direct":
        from mitsuba_path_guiding_torch.integrators.aux_integrators import render_direct
        return render_direct(scene, cfg)
    if name == "ao":
        from mitsuba_path_guiding_torch.integrators.aux_integrators import render_ao
        return render_ao(scene, cfg)
    raise ValueError(f"unknown integrator '{name}'")


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
    ap.add_argument("-I", "--integrator", default="guided", choices=INTEGRATORS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--aovs", action="store_true", help="also write albedo/normal/depth AOVs")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.integrator != "guided" and (args.denoise or args.aovs):
        ap.error("--denoise and --aovs need -I guided")

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
        f"integrator={args.integrator} guiding={'on' if args.guide else 'off'}")
    scene = build_scene(builtins[args.scene](), device=args.device)
    log(f"scene compiled on {scene.geo.p0.device}: {int(scene.geo.p0.shape[0])} triangles")
    if args.integrator != "guided":
        t0 = time.time()
        img = render_once(args.integrator, scene, RenderConfig(
            width=width, height=height, spp=args.spp, max_depth=args.depth, rr_depth=5,
            seed=args.seed)).cpu().numpy()
        log(f"render time ({args.integrator}): {time.time() - t0:.1f}s")
        write_image(out, img)
        log(f"wrote {out}  (mean {img.mean():.4f})")
        return 0
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
    if args.denoise:
        from mitsuba_path_guiding_torch.film.denoise import denoise_with_aux

        img, _ = denoise_with_aux(renderer, img)
        log("denoised")
    write_image(out, img)
    log(f"wrote {out}  (mean {img.mean():.4f})")
    if args.aovs:
        import os

        from mitsuba_path_guiding_torch.film.denoise import render_aovs

        aovs = render_aovs(renderer)
        stem = os.path.splitext(out)[0]
        for name, buf in aovs.items():
            write_image(f"{stem}_{name}.npy", buf)
        log(f"wrote AOVs: {', '.join(aovs)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
