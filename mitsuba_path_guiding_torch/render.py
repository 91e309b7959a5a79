"""Command-line renderer of the port (the counterpart of the JAX
package's render.py and of Mitsuba's ``mitsuba`` CLI): loads a Mitsuba
XML scene or a built-in one, renders it with the progressive guided
integrator or a one-shot integrator, and writes the image.  The built-in
scenes are ``cornell``, ``furnace`` (a diffuse sphere in a constant
environment, the white-furnace check), ``veach`` (Veach's MIS plates) and
``volbox`` (the Cornell box filled with a homogeneous scattering medium,
rendered by the volumetric tracer with guided distance sampling).

  python -m mitsuba_path_guiding_torch.render scene.xml -o out.exr
  python -m mitsuba_path_guiding_torch.render scene.xml -D n=4 -c ckpt.npz -o out.exr
  python -m mitsuba_path_guiding_torch.render cornell -o out.exr
  python -m mitsuba_path_guiding_torch.render veach -o out.npy -s 64 -G --device cpu
  python -m mitsuba_path_guiding_torch.render volbox -o vol.npy -r 32x32 -s 4 --device cpu
  python -m mitsuba_path_guiding_torch.render cornell -o c.exr -s 16 --denoise --aovs
  python -m mitsuba_path_guiding_torch.render cornell -I bdpt -o b.exr
  python -m mitsuba_path_guiding_torch.render cornell -I sppm -o s.npy -r 32x32 -s 1 --device cpu

  -o FILE      output (exr/pfm/png/npy; default <scene>.exr)
  -D key=val   $key define passed to the XML loader (repeatable)
  -s N         samples per pixel (default: the scene's sampler, 16 for a
               built-in)
  -d N         max path depth (default: the scene's integrator, 5)
  -r WxH       resolution (default: the scene's film, 256x256)
  -g / -G      enable / disable path guiding (default: on)
  -p N         samples per progression (default 4)
  -t SEC       time budget
  -c FILE      checkpoint: resume from FILE if it exists (then render -s
               more samples), save to it on exit
  -x           skip rendering if the output file exists
  -q           quiet (warnings only)
  -v / -vv     debug / trace log level
  -I NAME      integrator: guided (default; the progressive guided path
               tracer), path, direct, ao, ptracer, bdpt, vpl, pssmlt, mlt
               and erpt (-s counts mutations a pixel, seed paths for
               erpt), sppm (8 passes of 131072 photons) or photonmapper
               (131072 photons, -s camera samples with a final gather)
  --seed N     random seed
  --nee / --no-nee  next-event estimation on (default) or off
  --denoise    denoise the image (the neural denoiser over 4 spp of
               albedo, normal and depth feature buffers)
  --aovs       also write the feature buffers, <output>_{albedo,normal,depth}.npy
  --preview PORT  serve a live preview at http://127.0.0.1:PORT (0 picks
               a free port) while the guided render runs
  --device D   cuda (default) or cpu

The render runs on the card; without a card it raises unless ``--device
cpu`` is given.  The one-shot integrators render once at the given spp
with the JAX CLI's defaults (``--denoise``, ``--aovs``, ``-c`` and
``--preview`` need ``guided``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

BUILTINS = {"cornell": "cornell_box", "furnace": "furnace", "veach": "veach_mis",
            "volbox": "volumetric_box"}

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
    ap.add_argument("scene", help="scene XML path or built-in name (" + ", ".join(BUILTINS) + ")")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-D", "--define", action="append", default=[])
    ap.add_argument("-s", "--spp", type=int, default=None)
    ap.add_argument("-d", "--depth", type=int, default=None)
    ap.add_argument("-r", "--resolution", default=None)
    ap.add_argument("-g", "--guide", dest="guide", action="store_true", default=True)
    ap.add_argument("-G", "--no-guide", dest="guide", action="store_false")
    ap.add_argument("-p", "--pass-size", type=int, default=4)
    ap.add_argument("-t", "--time-budget", type=float, default=0.0)
    ap.add_argument("-c", "--checkpoint", default=None)
    ap.add_argument("-x", "--skip-existing", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true")
    ap.add_argument("-I", "--integrator", default="guided", choices=INTEGRATORS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nee", dest="nee", action="store_true", default=True)
    ap.add_argument("--no-nee", dest="nee", action="store_false")
    ap.add_argument("--denoise", action="store_true")
    ap.add_argument("--aovs", action="store_true", help="also write albedo/normal/depth AOVs")
    ap.add_argument("--preview", type=int, default=None, metavar="PORT",
                    help="serve a live preview at http://127.0.0.1:PORT (0 picks a free port)")
    ap.add_argument("-v", "--verbose", action="count", default=0,
                    help="-v debug, -vv trace log level")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.integrator != "guided" and (args.denoise or args.aovs or args.checkpoint
                                        or args.preview is not None):
        ap.error("--denoise, --aovs, -c and --preview need -I guided")

    from mitsuba_path_guiding_torch.utils import logger as mlog

    mlog.set_log_level(mlog.EWarn if args.quiet else mlog.ETrace if args.verbose >= 2
                       else mlog.EDebug if args.verbose == 1 else mlog.EInfo)

    def log(*a):
        if not args.quiet:
            print(*a, file=sys.stderr, flush=True)

    from mitsuba_path_guiding_torch.film.film import write_image
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    settings = {"width": 256, "height": 256, "spp": 16, "max_depth": 5, "rr_depth": 5}
    if args.scene in BUILTINS:
        from mitsuba_path_guiding_torch.scene import scenes as builtin

        desc = getattr(builtin, BUILTINS[args.scene])()
        scene_name = args.scene
    else:
        from mitsuba_path_guiding_torch.scene.xml_loader import load_scene_xml

        desc, settings = load_scene_xml(args.scene, dict(kv.split("=", 1) for kv in args.define))
        scene_name = os.path.splitext(os.path.basename(args.scene))[0]

    out = args.output or f"{scene_name}.exr"
    if args.skip_existing and os.path.exists(out):
        log(f"skipping: {out} exists (-x)")
        return 0
    spp = args.spp or settings["spp"]
    width, height = settings["width"], settings["height"]
    if args.resolution:
        width, height = (int(x) for x in args.resolution.lower().split("x"))
    max_depth = args.depth or settings["max_depth"]
    rr_depth = settings.get("rr_depth", 5)

    log(f"scene: {scene_name}  {width}x{height}@{spp}spp depth={max_depth} "
        f"integrator={args.integrator} guiding={'on' if args.guide else 'off'}")
    t0 = time.time()
    scene = build_scene(desc, device=args.device)
    log(f"scene compiled on {scene.geo.p0.device} in {time.time() - t0:.1f}s: "
        f"{int(scene.geo.p0.shape[0])} triangles")
    if args.integrator != "guided":
        t0 = time.time()
        img = render_once(args.integrator, scene, RenderConfig(
            width=width, height=height, spp=spp, max_depth=max_depth, rr_depth=rr_depth,
            seed=args.seed, use_nee=args.nee)).cpu().numpy()
        log(f"render time ({args.integrator}): {time.time() - t0:.1f}s")
        write_image(out, img)
        log(f"wrote {out}  (mean {img.mean():.4f})")
        return 0

    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )

    rcfg = RenderConfig(width=width, height=height, spp=0, max_depth=max_depth,
                        rr_depth=rr_depth, seed=args.seed, use_nee=args.nee)
    n_prog = max(1, (spp + args.pass_size - 1) // args.pass_size)
    pcfg = ProgressiveConfig(render=rcfg, samples_per_progression=min(args.pass_size, spp),
                             n_progressions=n_prog, max_seconds=args.time_budget,
                             guiding=args.guide)
    preview = None
    if args.preview is not None:
        from mitsuba_path_guiding_torch.utils.preview import PreviewServer

        preview = PreviewServer(port=args.preview)
        pcfg.queue = mlog.RenderQueue(listeners=[preview])
        log(f"live preview at http://127.0.0.1:{preview.port}")
    try:
        renderer = ProgressiveRenderer(scene, pcfg)
        if args.checkpoint and os.path.exists(args.checkpoint):
            from mitsuba_path_guiding_torch.utils.checkpoint import load_renderer_state

            load_renderer_state(renderer, args.checkpoint)
            log(f"resumed from {args.checkpoint} at {renderer.sample_counter} spp")
        last = [time.time()]

        def progress(r):
            now = time.time()
            log(f"progression {r.progression}/{n_prog}: {r.sample_counter} spp, "
                f"{now - last[0]:.1f}s")
            last[0] = now

        pcfg.on_postprogression = progress
        t0 = time.time()
        img = renderer.render().cpu().numpy()
        log(f"render time: {time.time() - t0:.1f}s")
        log(renderer.stats.report())
        if args.checkpoint:
            from mitsuba_path_guiding_torch.utils.checkpoint import save_renderer_state

            save_renderer_state(renderer, args.checkpoint)
            log(f"checkpoint written to {args.checkpoint}")
        if args.denoise:
            from mitsuba_path_guiding_torch.film.denoise import denoise_with_aux

            img, _ = denoise_with_aux(renderer, img)
            log("denoised")
        write_image(out, img)
        log(f"wrote {out}  (mean {img.mean():.4f})")
        if args.aovs:
            from mitsuba_path_guiding_torch.film.denoise import render_aovs

            aovs = render_aovs(renderer)
            stem = os.path.splitext(out)[0]
            for name, buf in aovs.items():
                write_image(f"{stem}_{name}.npy", buf)
            log(f"wrote AOVs: {', '.join(aovs)}")
    finally:
        if preview is not None:
            preview.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
