"""Reference values of chip_smoke.py's gradients_manifold_spectral_motion
phase from the JAX package.

On the CPU: the three gradients of tests/test_grad.py at chip_smoke's
``GRAD_RUNS`` (the furnace's albedo gradient beside its central finite
difference, the Cornell box's reflectance gradients, the emitter scale's
gradient beside L(1)); the image mean of each ``SPECTRAL_RUNS`` and
``MOTION_RUNS`` run at its seed and the next ``--seeds`` - 1, with the
standard error of a render's mean (the spread of the seeds' means); and
the motion vectors' summary at ``MOTION_VECTOR_RES``.  One JSON line a
run, with its seconds (most of them compiles); the last line gives the
tool's own run time.  chip_smoke.py holds the port's card results to
these (``SLICE13_REFERENCE``), since the card has no JAX.  The functions
here also serve tests/test_torch_grad.py and
tests/test_torch_motion_spectral.py at smaller sizes.

  JAX_PLATFORMS=cpu python tools/slice13_reference_means.py [--runs NAME ...] [--seeds N]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from chip_smoke import (  # noqa: E402
    GRAD_FD_EPS,
    GRAD_RUNS,
    MOTION_RUNS,
    MOTION_VECTOR_RES,
    SLICE13_SEEDS,
    SPECTRAL_RUNS,
    slice13_descs,
)


def jax_grad_scenes():
    from mitsuba_path_guiding_tpu.scene.builder import build_scene
    from mitsuba_path_guiding_tpu.scene.scenes import cornell_box, furnace

    return {"furnace": build_scene(furnace(albedo=0.5, env_radiance=1.0)),
            "cornell": build_scene(cornell_box())}


def jax_rays(scene, n_rays, seed_key, sample, film):
    """Camera rays and keys of tests/test_grad.py: pixels 0..n_rays-1 of a
    film x film image, sample ``sample``, uniforms under TAG_CAMERA."""
    import jax.numpy as jnp

    from mitsuba_path_guiding_tpu.core import rng
    from mitsuba_path_guiding_tpu.models.sensor import generate_rays

    pix = jnp.arange(n_rays, dtype=jnp.int32)
    rkeys = rng.ray_keys(rng.base_key(seed_key), pix, jnp.full_like(pix, sample))
    u = rng.event_uniform(rkeys, 1 << 20, 2)
    o, d, _ = generate_rays(scene.sensor, film, film, pix, u)
    return o, d, rkeys


def jax_gradient(run, scenes, n_rays=None, seeds=None):
    """One GRAD_RUNS gradient by jax.grad, with its test's companion
    value: {"grad": ..., "fd" | "base": ..., "seconds": ...}."""
    import jax
    import jax.numpy as jnp

    from mitsuba_path_guiding_tpu.integrators.path import trace
    from mitsuba_path_guiding_tpu.models.bsdf import types_present
    from mitsuba_path_guiding_tpu.models.emitter import kinds_present

    name, rays, n_seeds, depth, key_seed, film = GRAD_RUNS[run]
    rays = rays if n_rays is None else n_rays
    n_seeds = n_seeds if seeds is None else seeds
    scene = scenes[name]
    ek, mt = kinds_present(scene.emitters), types_present(scene.mats)
    t0 = time.time()
    if run == "emitter":
        o, d, rkeys = jax_rays(scene, rays, key_seed, 0, film)

        def loss(sc_):
            em = scene.emitters
            em2 = em._replace(packed=em.packed.at[:, 2:5].mul(sc_),
                              env_radiance=em.env_radiance * sc_)
            geo2 = scene.geo._replace(shade_packed=scene.geo.shade_packed.at[:, 20:23].mul(sc_))
            L, _, _ = trace(scene._replace(emitters=em2, geo=geo2), o, d, rkeys,
                            max_depth=depth, use_bvh=False, em_kinds=ek, mat_types=mt)
            return jnp.mean(L)

        g = float(jax.grad(loss)(1.0))
        return {"grad": g, "base": float(loss(1.0)), "seconds": round(time.time() - t0, 1)}
    waves = [jax_rays(scene, rays, key_seed, s, film) for s in range(n_seeds)]

    def loss(packed):
        sc_ = scene._replace(mats=scene.mats._replace(packed=packed))
        total = 0.0
        for o, d, rkeys in waves:
            L, _, _ = trace(sc_, o, d, rkeys, max_depth=depth, use_bvh=False, em_kinds=ek,
                            mat_types=mt)
            total = total + jnp.mean(L)
        return total / n_seeds

    g = np.asarray(jax.grad(loss)(scene.mats.packed))
    if run == "furnace":
        packed = scene.mats.packed
        f = [float(loss(packed.at[0, 1:4].add(dv))) for dv in (GRAD_FD_EPS, -GRAD_FD_EPS)]
        return {"grad": float(g[0, 1:4].sum()) / 3, "fd": (f[0] - f[1]) / (2 * GRAD_FD_EPS * 3),
                "seconds": round(time.time() - t0, 1)}
    return {"grad": g[:, 1:4].tolist(), "seconds": round(time.time() - t0, 1)}


def jax_spectral(run, descs, seed, res=None, spp=None, kind=None):
    """One SPECTRAL_RUNS image from the JAX package (numpy); ``kind``
    ("scan" or "bins") in place of the run's."""
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig
    from mitsuba_path_guiding_tpu.integrators.spectral import render_spectral, render_spectral_scan

    name, run_kind, r, s, depth, _, n_bins = SPECTRAL_RUNS[run]
    kind = run_kind if kind is None else kind
    r, s = r if res is None else res, s if spp is None else spp
    cfg = RenderConfig(width=r, height=r, spp=s, max_depth=depth, seed=seed)
    fn = render_spectral_scan if kind == "scan" else render_spectral
    return np.asarray(fn(descs[name], cfg, n_bins=n_bins))


def jax_motion_blur(run, descs, seed, res=None, spp=None):
    """One MOTION_RUNS image from the JAX package (numpy)."""
    from mitsuba_path_guiding_tpu.integrators.motion import render_motion_blur
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig

    name, r, s, depth, _, bins = MOTION_RUNS[run]
    r, s = r if res is None else res, s if spp is None else spp
    cfg = RenderConfig(width=r, height=r, spp=s, max_depth=depth, seed=seed)
    return np.asarray(render_motion_blur(descs[name], cfg, time_bins=bins))


def motion_vector_summary(mv):
    """The render_motion checks' numbers: pixels moving by more than 0.2
    in x, their mean dx, the largest |dy| and the still pixels' count."""
    mv = np.asarray(mv)
    moving = np.abs(mv[..., 0]) > 0.2
    return {"moving": int(moving.sum()), "mean_dx_moving": float(mv[..., 0][moving].mean()),
            "max_abs_dy": float(np.abs(mv[..., 1]).max()),
            "max_abs_dx": float(np.abs(mv[..., 0]).max()),
            "still": int((np.abs(mv[..., 0]) < 1e-5).sum())}


def main(argv=None):
    names = [*GRAD_RUNS, *SPECTRAL_RUNS, *MOTION_RUNS, "motion_vectors"]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", nargs="*", default=names, choices=names)
    ap.add_argument("--seeds", type=int, default=SLICE13_SEEDS)
    args = ap.parse_args(argv)
    from mitsuba_path_guiding_tpu.integrators.motion import render_motion
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig
    from mitsuba_path_guiding_tpu.scene import scenes

    descs = slice13_descs(scenes)
    grad_scenes = jax_grad_scenes()
    t_all = time.time()
    for run in args.runs:
        t0 = time.time()
        if run in GRAD_RUNS:
            print(json.dumps({"run": run, **jax_gradient(run, grad_scenes)}), flush=True)
            continue
        if run == "motion_vectors":
            res = MOTION_VECTOR_RES
            mv = render_motion(descs["moving_0.4"], RenderConfig(width=res, height=res, spp=1))
            print(json.dumps({"run": run, "resolution": res, **motion_vector_summary(mv),
                              "seconds": round(time.time() - t0, 1)}), flush=True)
            continue
        table, fn = ((SPECTRAL_RUNS, jax_spectral) if run in SPECTRAL_RUNS
                     else (MOTION_RUNS, jax_motion_blur))
        seed = table[run][-2] if run in SPECTRAL_RUNS else table[run][4]
        imgs = [fn(run, descs, seed + k) for k in range(args.seeds)]
        means = [float(img.mean()) for img in imgs]
        print(json.dumps({
            "run": run, "seed": seed, "mean": means[0], "se": float(np.std(means, ddof=1)),
            "seed_means": means, "finite": bool(all(np.isfinite(i).all() for i in imgs)),
            "seconds": round(time.time() - t0, 1)}), flush=True)
    print(json.dumps({"tool_seconds": round(time.time() - t_all, 1)}), flush=True)


if __name__ == "__main__":
    main()
