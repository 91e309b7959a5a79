"""Held-out quality gates of the neural denoiser, and a training sweep
over seeds that keeps the best weights (port of the reference's
tools/seed_sweep_dn.py).

Gate scenes, none of them in the training set (``film/train_denoiser.py``
renders Cornell variants, veach_mis, the furnace and bounce-lamp and
door_room variants with other parameters):
  - ``cornell``: the standard Cornell box;
  - ``lamp``: bounce_lamp_room(), indirect light only, the noisiest class;
  - ``door``: door_room(40000), a glossy interior.
Each is rendered at 96x96: a target (192 spp, 384 for the lamp) and a
4-spp image, with one camera wave of feature buffers.  A gate's metric is
the mean squared error, summed over channels, of the neural result, the
a-trous result and the noisy image against the target, off the emitters
(target sum below 3).  ``quality`` is the Cornell box with the feature
buffers of four camera waves, ``tests/test_denoise_quality.py``'s recipe:
weights pass where the neural MSE is below QUALITY_BARS times the a-trous
and the noisy MSE.

Usage::

    python -m mitsuba_path_guiding_torch.film.denoise_gate eval WEIGHTS.npz ...
    python -m mitsuba_path_guiding_torch.film.denoise_gate sweep [SEED ...]

``eval`` prints one JSON line of every gate's ratios for each weights
file (``package`` names the checked-in one); ``sweep`` trains each seed
(0-5 by default) for ``DN_STEPS`` (3000) steps on ``DN_DATA``, prints each
seed's ratios, and copies the best weights (the least mean neural over
a-trous ratio of the three gates) to ``DN_OUT``.  Both run on the card
unless given ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

from mitsuba_path_guiding_torch.film import neural_denoise as nd
from mitsuba_path_guiding_torch.film import train_denoiser as td

GATES = ("cornell", "lamp", "door")
QUALITY = "quality"
QUALITY_BARS = (0.9, 0.35)  # neural MSE below these times the a-trous and the noisy MSE
GATE_RES = 96
_CACHE: dict = {}


def _gate_desc(name):
    from mitsuba_path_guiding_torch.scene.scenes import bounce_lamp_room, cornell_box, door_room

    return {"cornell": cornell_box, QUALITY: cornell_box, "lamp": bounce_lamp_room,
            "door": lambda: door_room(40_000)}[name]()


def gate_buffers(name, device="cuda"):
    """(target, noisy, albedo, normal, depth, a-trous result) of a gate,
    tensors on ``device`` (cached)."""
    from mitsuba_path_guiding_torch.film.denoise import denoise_hdr
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_torch.scene.builder import TWOLEVEL_MIN_TRIS, build_scene

    key = (name, str(torch.device(device)))
    if key in _CACHE:
        return _CACHE[key]
    scene = build_scene(_gate_desc(name), device=device)
    w = h = GATE_RES
    depth = 5 if name == "lamp" else 4
    ref_spp = 384 if name == "lamp" else 192
    if name == QUALITY:  # the Cornell gate's renders
        ref, noisy = gate_buffers("cornell", device)[:2]
        albedo, normal, dep = td.render_aov_buffers(scene, w, h, 4)
    else:
        ref = render(scene, RenderConfig(width=w, height=h, spp=ref_spp, max_depth=depth,
                                         seed=11))
        noisy = render(scene, RenderConfig(width=w, height=h, spp=4, max_depth=depth, seed=3))
        aux = td.aov_wave(scene, w, h, 4, 0,
                          use_bvh=int(scene.geo.p0.shape[0]) > TWOLEVEL_MIN_TRIS)
        albedo, normal = aux.albedo.reshape(h, w, 3), aux.normal.reshape(h, w, 3)
        dep = aux.depth_t.reshape(h, w)
    den_a = denoise_hdr(noisy, albedo, normal, dep)
    _CACHE[key] = (ref, noisy, albedo, normal, dep, den_a)
    return _CACHE[key]


def _params_on(params, device):
    if isinstance(params, str):
        params = nd.load_params(params)
    return {k: nd._f32(v).to(device) for k, v in params.items()}


def gate_metric(params, name, device="cuda"):
    """(neural, a-trous, noisy) masked MSE of gate ``name`` with HWIO
    ``params`` (a dict, or a weights file's path)."""
    ref, noisy, albedo, normal, depth, den_a = gate_buffers(name, device)
    den_n = nd.denoise_neural_params(_params_on(params, device), noisy, albedo, normal, depth)
    mask = ref.sum(-1) < 3.0

    def mse(a):
        return float(((a - ref) ** 2).sum(-1)[mask].mean())

    return mse(den_n), mse(den_a), mse(noisy)


def evaluate(params, device="cuda", gates=GATES + (QUALITY,)):
    """Every gate's MSEs and ratios, and whether the quality bars hold."""
    out = {}
    for g in gates:
        m_n, m_a, m_noisy = gate_metric(params, g, device)
        out[g] = {"neural": m_n, "atrous": m_a, "noisy": m_noisy, "n_over_a": m_n / m_a,
                  "n_over_noisy": m_n / m_noisy, "a_over_noisy": m_a / m_noisy}
    if QUALITY in out:
        q = out[QUALITY]
        out["quality_pass"] = bool(q["n_over_a"] < QUALITY_BARS[0]
                                   and q["n_over_noisy"] < QUALITY_BARS[1])
    return out


def sweep(seeds=range(6), data=None, steps=3000, device="cuda", out=None, log=print):
    """Train each seed, score it on the gates, copy the best weights to
    ``out`` (``DN_OUT`` or train_denoiser's default).  Returns the seeds'
    records, best first."""
    out = out or os.environ.get("DN_OUT", td.DEFAULT_OUT)
    data = data or os.environ.get("DN_DATA", td.data_path("*"))
    results = []
    for seed in seeds:
        wpath = os.path.join(os.path.dirname(os.path.abspath(out)), f"dnw_{seed}.npz")
        t0 = time.time()
        _, rec = td.train(data, steps=steps, seed=seed, device=device, out=wpath,
                          log=lambda s: None)
        ratios, line, collapsed = [], [], True
        for g in GATES:
            m_n, m_a, m_noisy = gate_metric(wpath, g, device)
            ratios.append(m_n / m_a)
            line.append(f"{g} n/a {m_n / m_a:.3f} (n/noisy {m_n / m_noisy:.3f})")
            if abs(m_n - m_a) / max(m_a, 1e-12) > 1e-3:
                collapsed = False
        score = float(np.mean(ratios))
        quality = evaluate(wpath, device, gates=(QUALITY,))
        q = quality[QUALITY]
        log(f"seed {seed}: mean n/a {score:.3f} | " + " | ".join(line)
            + ("  [COLLAPSED]" if collapsed else "")
            + f" | quality n/a {q['n_over_a']:.3f} n/noisy {q['n_over_noisy']:.3f}"
            + (" pass" if quality["quality_pass"] else " fail") + f"  ({time.time() - t0:.0f}s)")
        results.append({"score": score, "seed": seed, "path": wpath, "collapsed": collapsed,
                        "ratios": dict(zip(GATES, ratios)), "quality": quality,
                        "train_seconds": rec["seconds"]})
    results.sort(key=lambda r: (r["score"], r["seed"]))
    log(f"collapsed seeds: {sum(r['collapsed'] for r in results)}/{len(results)}")
    best = results[0]
    log(f"best seed: {best['seed']} score: {best['score']:.4f}")
    shutil.copy(best["path"], out)
    log(f"wrote {out}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("eval", "sweep"))
    ap.add_argument("args", nargs="*", help="weights files (eval) or seeds (sweep)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.what == "sweep":
        sweep([int(s) for s in args.args] or range(6),
              steps=int(os.environ.get("DN_STEPS", "3000")), device=args.device)
        return 0
    for path in args.args:
        t0 = time.time()
        rec = evaluate(nd.load_params() if path == "package" else path, device=args.device)
        print(json.dumps({"weights": path, "seconds": round(time.time() - t0, 3), **rec}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
