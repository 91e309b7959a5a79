"""Train the denoiser with the JAX package's tool (tools/train_denoiser.py)
and with the port (mitsuba_path_guiding_torch/film/train_denoiser.py) on
one dataset, on the CPU, and print each run's loss on fixed held-out
batches beside the a-trous base's (the zero residual).

The two trainers draw their crops from different generators, so their
weights differ; what this compares is where training takes each of them
from the same start.

    JAX_PLATFORMS=cpu python tools/denoise_train_parity.py [--steps 400] [--seeds 0 1]
        [--data denoise_data_torch.npz] [--gate]

By default six synthetic 128x128 images (the tool crops 64x64 from a
128-pixel image; about two minutes a seed on four cores); ``--data``
takes a dataset that ``python -m
mitsuba_path_guiding_torch.film.train_denoiser gen1`` rendered on the
card, and ``--gate`` scores both runs' weights on the quality gate of
``film/denoise_gate.py`` (the Cornell box at 96x96, rendered here by the
port on the CPU).  The first line gives each image's zero-residual loss
and share of zero-albedo pixels.
"""
import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from mitsuba_path_guiding_torch.film import neural_denoise as tnn  # noqa: E402
from mitsuba_path_guiding_torch.film import train_denoiser as ttd  # noqa: E402


def synthetic_dataset(n=6, res=128, seed=3):
    """x (n, res, res, 10): a smooth colour field under gamma noise with
    fireflies, a noisy albedo, two-plane normals and a depth step; y the
    clean colour field."""
    rs = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res), indexing="ij")
    xs, ys = [], []
    for i in range(n):
        base = np.stack([0.3 + 0.5 * xx, 0.2 + 0.4 * yy, 0.4 + 0.2 * xx * yy], -1) * (1 + 0.3 * i)
        noisy = base * rs.gamma(2.0, 0.5, (res, res, 1))
        noisy[rs.random((res, res)) < 0.01] = 30.0
        albedo = np.clip(base / (1 + 0.3 * i) + 0.05 * rs.standard_normal((res, res, 3)), 0, 1)
        normal = np.stack([0.2 * xx - 0.1, np.where(yy > 0.5, 0.9, 0.1), np.ones_like(xx)], -1)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        depth = np.where(xx > 0.6, 2.0, 5.0 + yy)[..., None]
        xs.append(np.concatenate([noisy, albedo, normal, depth], -1))
        ys.append(base)
    return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1],
                    help="none: print the dataset's per-image record only")
    ap.add_argument("--data", help="a dataset .npz (x, y) in place of the synthetic one")
    ap.add_argument("--gate", action="store_true", help="score the quality gate too")
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("jax_train_denoiser",
                                                  os.path.join(ROOT, "tools", "train_denoiser.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    from mitsuba_path_guiding_tpu.film import neural_denoise as jnn

    x, y = ttd.load_dataset(args.data) if args.data else synthetic_dataset()
    X, Y = ttd.with_bases(x, "cpu"), torch.from_numpy(y)
    held = [ttd.draw_batch(X, Y, torch.Generator().manual_seed(100 + k), 8, 64) for k in range(4)]

    def held_loss(residual):
        with torch.no_grad():
            return float(np.mean([float(ttd.loss_fn(residual, xb, yb)) for xb, yb in held]))

    zero = float(np.mean([float(ttd.zero_residual_loss(xb, yb)) for xb, yb in held]))
    # each whole image's zero-residual loss and its share of pixels with a
    # zero albedo (misses and specular surfaces, demodulated by 1e-3)
    print(json.dumps({"images": int(x.shape[0]), "zero_residual_by_image": [
        round(float(ttd.zero_residual_loss(X[n:n + 1], Y[n:n + 1])), 4) for n in range(len(X))],
        "zero_albedo_share": [round(float((x[n, ..., 3:6].max(-1) == 0).mean()), 4)
                              for n in range(len(x))]}), flush=True)
    if args.gate:
        from mitsuba_path_guiding_torch.film import denoise_gate as dg

        q = dg.evaluate(tnn.load_params(), device="cpu", gates=(dg.QUALITY,))[dg.QUALITY]
        print(json.dumps({"weights": "checked-in", "quality": {
            k: q[k] for k in ("n_over_a", "n_over_noisy", "a_over_noisy")}}), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data.npz")
        np.savez(data, x=x, y=y)
        for seed in args.seeds:
            t0 = time.time()
            out = os.path.join(tmp, f"jax_{seed}.npz")
            os.environ["DN_OUT"] = out
            jtool.train(data, steps=args.steps, seed=seed)
            jp = {k: torch.from_numpy(np.array(v)) for k, v in jnn.load_params(out).items()}
            net, _ = ttd.train((x, y), steps=args.steps, seed=seed, device="cpu",
                               log=lambda s: None)
            tp = {k: v.half().float() for k, v in net.params().items()}  # as written to a file
            rec = {"seed": seed, "steps": args.steps, "images": int(x.shape[0]),
                   "zero_residual": zero, "jax": held_loss(lambda q: tnn.apply_net(jp, q)),
                   "port": held_loss(lambda q: tnn.apply_net(tp, q))}
            if args.gate:
                for name, params in (("jax", jp), ("port", tp)):
                    q = dg.evaluate(params, device="cpu", gates=(dg.QUALITY,))
                    rec[f"quality_{name}"] = {k: q[dg.QUALITY][k]
                                              for k in ("n_over_a", "n_over_noisy")}
            rec["seconds"] = round(time.time() - t0, 1)
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
