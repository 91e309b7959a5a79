"""Utility launcher, the ``mtsutil`` equivalent (a port of the JAX
package's util.py; Mitsuba's mtsutil and its utility plugins: tonemap,
addimages, joinrgb, scene info, scene2obj, serialized2obj, kdbench):

  python -m mitsuba_path_guiding_torch.util tonemap in.exr out.png [--key K]
  python -m mitsuba_path_guiding_torch.util addimages a.exr b.exr out.exr [-w WA WB]
  python -m mitsuba_path_guiding_torch.util diff a.exr b.exr [-o diff.png]
  python -m mitsuba_path_guiding_torch.util info scene.xml
  python -m mitsuba_path_guiding_torch.util denoise in.exr albedo.npy normal.npy out.exr
  python -m mitsuba_path_guiding_torch.util joinrgb r.exr g.exr b.exr out.exr
  python -m mitsuba_path_guiding_torch.util scene2obj scene.xml out.obj
  python -m mitsuba_path_guiding_torch.util serialized2obj m.serialized out.obj [--index I]
  python -m mitsuba_path_guiding_torch.util import scene.dae out.obj
  python -m mitsuba_path_guiding_torch.util kdbench mesh.ply [-x RAYS]

``_read`` is also how the scene compiler reads bitmap textures, envmaps
and heightfields.  The commands that compile a scene or run torch work
(tonemap, denoise, info, scene2obj, import, kdbench) take ``--device``:
the card by default, ``cpu`` on request.  ``kdbench`` times the
``intersect_tiled`` CUDA kernel on the card and the BVH walk's plain
version on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _read(path: str) -> np.ndarray:
    low = path.lower()
    if low.endswith(".npy"):
        return np.load(path)
    if low.endswith(".pfm"):
        from mitsuba_path_guiding_torch.film.film import read_pfm

        return read_pfm(path)
    if low.endswith(".exr"):
        return _read_exr(path)
    raise ValueError(f"cannot read {path} (supported: npy, pfm, exr)")


def _read_exr(path: str) -> np.ndarray:
    """Scanline EXR (NONE/RLE/ZIP/PIZ/PXR24, half/float, multichannel),
    see film/exr.py."""
    from mitsuba_path_guiding_torch.film.exr import read_exr_rgb

    return read_exr_rgb(path)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mitsuba_path_guiding_torch.util")
    sub = ap.add_subparsers(dest="tool", required=True)

    def device_arg(p):
        p.add_argument("--device", default=None, help="cuda (default) or cpu")
        return p

    t = device_arg(sub.add_parser("tonemap"))
    t.add_argument("input")
    t.add_argument("output")
    t.add_argument("--key", type=float, default=0.18)
    t.add_argument("--gamma-only", action="store_true")

    a = sub.add_parser("addimages")
    a.add_argument("a")
    a.add_argument("b")
    a.add_argument("output")
    a.add_argument("-w", "--weights", nargs=2, type=float, default=[0.5, 0.5])

    d = sub.add_parser("diff")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("-o", "--output", default=None)

    i = device_arg(sub.add_parser("info"))
    i.add_argument("scene")

    dn = device_arg(sub.add_parser("denoise"))
    dn.add_argument("input")
    dn.add_argument("albedo")
    dn.add_argument("normal")
    dn.add_argument("output")

    j = sub.add_parser("joinrgb")  # utils/joinrgb.cpp
    j.add_argument("r")
    j.add_argument("g")
    j.add_argument("b")
    j.add_argument("output")

    s2o = device_arg(sub.add_parser("scene2obj"))  # utils/scene2obj.cpp
    s2o.add_argument("scene")
    s2o.add_argument("output")

    ser = sub.add_parser("serialized2obj")  # utils/serialized2obj.cpp
    ser.add_argument("input")
    ser.add_argument("output")
    ser.add_argument("--index", type=int, default=0)

    imp = device_arg(sub.add_parser("import"))  # converter/mtsimport.cpp (COLLADA/OBJ)
    imp.add_argument("input", help=".dae or .obj file")
    imp.add_argument("output", help="output .obj geometry dump")

    kb = device_arg(sub.add_parser("kdbench"))  # utils/kdbench.cpp
    kb.add_argument("mesh", help=".obj/.ply/.serialized mesh or scene .xml")
    kb.add_argument("-x", "--rays", type=int, default=1 << 20)

    args = ap.parse_args(argv)
    from mitsuba_path_guiding_torch.film.film import write_image

    if args.tool == "tonemap":
        import torch

        from mitsuba_path_guiding_torch.core.device import resolve_device
        from mitsuba_path_guiding_torch.core.spectrum import reinhard_tonemap

        img = _read(args.input)
        if not args.gamma_only:
            x = torch.as_tensor(np.ascontiguousarray(img, np.float32),
                                device=resolve_device(args.device))
            img = reinhard_tonemap(x, key=args.key).cpu().numpy()
        write_image(args.output, np.clip(img, 0, 1))
        print(f"wrote {args.output}")

    elif args.tool == "addimages":
        a_img, b_img = _read(args.a), _read(args.b)
        wa, wb = args.weights
        write_image(args.output, wa * a_img + wb * b_img)
        print(f"wrote {args.output}")

    elif args.tool == "diff":
        a_img, b_img = _read(args.a), _read(args.b)
        err = a_img - b_img
        rmse = float(np.sqrt((err**2).mean()))
        rel_mse = float(((err**2) / (b_img**2 + 1e-2)).mean())
        print(f"RMSE: {rmse:.6f}  relMSE: {rel_mse:.6f}  "
              f"maxAbs: {float(np.abs(err).max()):.6f}")
        if args.output:
            write_image(args.output, np.abs(err))
            print(f"wrote {args.output}")
        return 0 if rmse < 1e30 else 1

    elif args.tool == "info":
        from mitsuba_path_guiding_torch.scene.builder import build_scene
        from mitsuba_path_guiding_torch.scene.xml_loader import load_scene_xml

        desc, settings = load_scene_xml(args.scene)
        sc = build_scene(desc, device=args.device)
        print(f"scene: {args.scene}")
        print(f"  triangles: {int(sc.geo.p0.shape[0])}")
        print(f"  materials: {int(sc.mats.type.shape[0])}")
        print(f"  emitters:  {int(sc.emitters.kind.shape[0])}")
        print(f"  bvh nodes: {int(sc.bvh.child0.shape[0])} (depth {sc.bvh.max_depth})")
        print(f"  settings:  {settings}")

    elif args.tool == "denoise":
        import torch

        from mitsuba_path_guiding_torch.core.device import resolve_device
        from mitsuba_path_guiding_torch.film.denoise import atrous_denoise

        dev = resolve_device(args.device)
        img, alb, nrm = (torch.as_tensor(np.ascontiguousarray(_read(p), np.float32), device=dev)
                         for p in (args.input, args.albedo, args.normal))
        depth = torch.ones(img.shape[:2], dtype=torch.float32, device=dev)
        write_image(args.output, atrous_denoise(img, alb, nrm, depth).cpu().numpy())
        print(f"wrote {args.output}")

    elif args.tool == "joinrgb":
        # merge three monochrome renders into one RGB image
        r_img, g_img, b_img = _read(args.r), _read(args.g), _read(args.b)
        mono = lambda x: x.mean(axis=-1) if x.ndim == 3 else x
        out = np.stack([mono(r_img), mono(g_img), mono(b_img)], axis=-1)
        write_image(args.output, out)
        print(f"wrote {args.output}")

    elif args.tool == "scene2obj":
        # geometry dump of the compiled scene
        sc = _load_any_scene(args.scene, args.device)
        p0, e1, e2 = (x.cpu().numpy() for x in (sc.geo.p0, sc.geo.e1, sc.geo.e2))
        _write_obj(args.output, p0, p0 + e1, p0 + e2)
        print(f"wrote {args.output} ({len(p0)} triangles)")

    elif args.tool == "serialized2obj":
        from mitsuba_path_guiding_torch.scene.shapes import load_serialized

        mesh = load_serialized(args.input, args.index)
        with open(args.output, "w") as f:
            for v in mesh.vertices:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            if mesh.normals is not None:
                for n in mesh.normals:
                    f.write(f"vn {n[0]} {n[1]} {n[2]}\n")
            for face in mesh.faces:
                i, jf, k = face + 1
                if mesh.normals is not None:
                    f.write(f"f {i}//{i} {jf}//{jf} {k}//{k}\n")
                else:
                    f.write(f"f {i} {jf} {k}\n")
        print(f"wrote {args.output} ({len(mesh.faces)} faces)")

    elif args.tool == "import":
        # COLLADA/OBJ import -> compiled scene -> geometry dump (Mitsuba's
        # mtsimport writes scene XML; here the geometry of the load path)
        sc = _load_any_scene(args.input, args.device)
        p0, e1, e2 = (x.cpu().numpy() for x in (sc.geo.p0, sc.geo.e1, sc.geo.e2))
        _write_obj(args.output, p0, p0 + e1, p0 + e2)
        print(f"imported {args.input}: {len(p0)} triangles -> {args.output}")

    elif args.tool == "kdbench":
        kdbench(args.mesh, args.rays, args.device)

    return 0


def kdbench(path: str, n: int, device=None) -> dict:
    """Acceleration-structure benchmark (Mitsuba's utils/kdbench.cpp): the
    BVH build's host time, then the closest hit of ``n`` random rays from
    the scene's box, one warm-up and the median of 5 timed calls.  On the
    card that is the ``intersect_tiled`` CUDA kernel's card time, each
    call between two CUDA events with a spin queued ahead of them so the
    host's launch cost stays off the card's clock; on the CPU it is the
    wall time of the BVH walk's plain version.  Prints both and returns
    them."""
    import statistics

    import torch

    from mitsuba_path_guiding_torch.accel.bvh import build_bvh

    sc = _load_any_scene(path, device)
    dev = sc.geo.p0.device
    p0, e1, e2 = (x.cpu().numpy() for x in (sc.geo.p0, sc.geo.e1, sc.geo.e2))
    t0 = time.time()
    bvh = build_bvh(p0, e1, e2)
    t_build = time.time() - t0
    ntri = len(p0)
    print(f"BVH build: {ntri} tris in {t_build*1e3:.1f} ms "
          f"({ntri/max(t_build,1e-9)/1e6:.2f} Mtris/s), "
          f"{int(bvh.child0.shape[0])} nodes, depth {bvh.max_depth}")
    lo, hi = sc.aabb_min.cpu().numpy(), sc.aabb_max.cpu().numpy()
    rs = np.random.default_rng(0)
    o = torch.as_tensor(lo + rs.random((n, 3)) * (hi - lo), dtype=torch.float32, device=dev)
    d_np = rs.normal(size=(n, 3))
    d = torch.as_tensor(d_np / np.linalg.norm(d_np, axis=-1, keepdims=True),
                        dtype=torch.float32, device=dev)
    reps = 5
    if dev.type == "cuda":
        from mitsuba_path_guiding_torch.accel.traverse import tri_pack_rows
        from mitsuba_path_guiding_torch.ops.intersect_tiled import intersect_tiled

        pack = tri_pack_rows(sc.geo)
        tmax = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
        intersect_tiled(pack, o, d, tmax, ntri)
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            intersect_tiled(pack, o, d, tmax, ntri)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        name = "intersect_tiled (CUDA kernel)"
    else:
        from mitsuba_path_guiding_torch.accel.traverse import intersect_bvh

        intersect_bvh(sc.geo, sc.bvh, o, d)
        times = []
        for _ in range(reps):
            t0 = time.time()
            intersect_bvh(sc.geo, sc.bvh, o, d)
            times.append(time.time() - t0)
        name = "BVH (plain)"
    dt = statistics.median(times)
    print(f"{name} traversal: {n} rays in {dt*1e3:.5f} ms -> {n/dt/1e6:.1f} Mrays/s")
    return {"kernel": name, "triangles": ntri, "rays": n, "build_ms": t_build * 1e3,
            "ms": dt * 1e3, "mrays_per_s": n / dt / 1e6}


def _load_any_scene(path: str, device=None):
    """Scene XML or a bare mesh file -> compiled SceneData on ``device``."""
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    low = path.lower()
    if low.endswith(".xml"):
        from mitsuba_path_guiding_torch.scene.xml_loader import load_scene_xml

        desc, _ = load_scene_xml(path)
        return build_scene(desc, device=device)
    if low.endswith(".dae"):
        from mitsuba_path_guiding_torch.scene.collada import load_dae

        desc = load_dae(path)
        if not desc.get("emitters"):
            desc["emitters"] = [{"type": "constant", "radiance": [1.0] * 3}]
        return build_scene(desc, device=device)
    kind = ("obj" if low.endswith(".obj") else
            "ply" if low.endswith(".ply") else
            "serialized" if low.endswith(".serialized") else None)
    if kind is None:
        raise ValueError(f"cannot load {path}")
    desc = {
        "sensor": {"type": "perspective"},
        "shapes": [{"type": kind, "filename": path,
                    "bsdf": {"type": "diffuse"}}],
        "emitters": [{"type": "constant", "radiance": [1.0] * 3}],
    }
    return build_scene(desc, device=device)


def _write_obj(path: str, p0, p1, p2):
    with open(path, "w") as f:
        for a, b, c in zip(p0, p1, p2):
            f.write(f"v {a[0]} {a[1]} {a[2]}\n")
            f.write(f"v {b[0]} {b[1]} {b[2]}\n")
            f.write(f"v {c[0]} {c[1]} {c[2]}\n")
        for i in range(len(p0)):
            f.write(f"f {3*i+1} {3*i+2} {3*i+3}\n")


if __name__ == "__main__":
    sys.exit(main())
