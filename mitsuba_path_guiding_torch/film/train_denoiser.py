"""Train the neural denoiser (``film/neural_denoise.py``) on the port's
own renders, on the card (port of the reference's tools/train_denoiser.py).

Data: randomized Cornell-family scenes (wall colours, box materials,
light colour and strength, camera jitter), veach_mis, the furnace, and
bounce-lamp and door_room variants, rendered at 4 spp (noisy, three
realizations a scene) and at 384 spp (the target) with albedo, normal and
depth buffers.  The standard Cornell box is left out: it is the held-out
gate scene (``film/denoise_gate.py``).

The net trains with Adam on a linear-warmup cosine schedule, on random
crops with random horizontal flips, against an L1 plus finite-difference
gradient loss in demodulated log space.  The training is repeatable: the
crops, flips and initial weights come from seeded generators on the
training device, and cuDNN runs deterministic algorithms without TF32,
so one seed gives one set of weights bit for bit.

Usage::

    python -m mitsuba_path_guiding_torch.film.train_denoiser gen1|gen2|gen3
    python -m mitsuba_path_guiding_torch.film.train_denoiser [steps]

``gen1`` renders the 16-scene recipe into ``denoise_data_torch.npz`` of
the temporary directory (``gen2``, ``gen3``: 16 and 32 other scenes into
``denoise_data_torch2.npz``, ``denoise_data_torch3.npz``); a number of
steps (3000 by default) trains on ``DN_DATA`` (a path or a glob, by
default every ``denoise_data_torch*.npz`` there, rendering ``gen1``
first when it is missing) from seed ``DN_SEED`` (0) and writes the
weights to ``DN_OUT`` (``build/denoiser/denoiser_weights.npz`` of the
repository; never the package's own file).  ``--device cpu`` runs it on
the CPU; by default it runs on the card.
"""
from __future__ import annotations

import argparse
import glob
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from mitsuba_path_guiding_torch.film import neural_denoise as nd
from mitsuba_path_guiding_torch.ops.build import REPO_ROOT
from mitsuba_path_guiding_torch.scene.scenes import (
    bounce_lamp_room,
    cornell_box,
    door_room,
    furnace,
    veach_mis,
)
from mitsuba_path_guiding_torch.scene.transforms import look_at

RES = 128
REF_SPP = 384
NOISY_SPP = 4
N_NOISY = 3  # noisy realizations per scene
AOV_DEPTH = 2
RENDER_DEPTH = 4
PRINT_EVERY = 200
NORMAL_X = 6  # the dataset's channel of the normal's x, negated by a flip
DEFAULT_OUT = os.path.join(REPO_ROOT, "build", "denoiser", "denoiser_weights.npz")
GENERATIONS = {"gen1": (10, 42, ""), "gen2": (16, 7, "2"), "gen3": (32, 13, "3")}


def data_path(suffix: str = "") -> str:
    return os.path.join(tempfile.gettempdir(), f"denoise_data_torch{suffix}.npz")


def rand_cornell(rs):
    """Cornell-family variant from numpy Generator ``rs``: randomized wall
    albedos, box material and placement, light colour and strength (the
    reference's draws, so a seed gives its scenes)."""
    def rc():
        return list(np.clip(rs.uniform(0.05, 0.85, 3), 0, 1))

    desc = cornell_box(
        light_scale=float(rs.uniform(0.5, 2.0)),
        box_material=rs.choice(["diffuse", "mirror", "glass"]),
    )
    mats = [
        {"type": "diffuse", "reflectance": rc()},
        {"type": "roughconductor", "alpha": float(rs.uniform(0.05, 0.4))},
        {"type": "plastic", "diffuse_reflectance": rc()},
        {"type": "roughplastic", "diffuse_reflectance": rc(),
         "alpha": float(rs.uniform(0.05, 0.3))},
    ]
    for s in desc["shapes"]:
        if s.get("emitter"):
            e = np.asarray(s["emitter"]["radiance"], np.float32)
            tint = rs.uniform(0.5, 1.5, 3)
            s["emitter"]["radiance"] = list((e * tint).astype(float))
        elif s["type"] == "rectangle":
            if rs.random() < 0.7:
                s["bsdf"] = {"type": "diffuse", "reflectance": rc()}
        elif s["type"] == "cube":
            s["bsdf"] = mats[rs.integers(len(mats))]
    cam = [float(rs.uniform(-0.4, 0.4)), float(rs.uniform(0.6, 1.4)), -3.2]
    desc["sensor"]["to_world"] = look_at(cam, [0, 1.0, 0])
    return desc


def aov_wave(scene, w, h, seed, sample, use_bvh=False):
    """One camera wave's PathAux (albedo, normal, depth of the first
    hits) traced to depth AOV_DEPTH from key ``seed`` at sample index
    ``sample``."""
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.integrators.path import trace
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present
    from mitsuba_path_guiding_torch.models.sensor import generate_rays

    dev = scene.geo.p0.device
    pix = torch.arange(w * h, dtype=torch.int64, device=dev)
    rk = rng.ray_keys(rng.base_key(seed, dev), pix, torch.full_like(pix, sample))
    u_cam = rng.event_uniform(rk, rng.TAG_CAMERA, 2)
    o, d, _ = generate_rays(scene.sensor, w, h, pix, u_cam)
    _, aux, _ = trace(scene, o, d, rk, max_depth=AOV_DEPTH, use_bvh=use_bvh,
                      em_kinds=kinds_present(scene.emitters), mat_types=types_present(scene.mats))
    return aux


def render_aov_buffers(scene, w, h, seed):
    """Albedo (h, w, 3), unit normal (h, w, 3) and depth (h, w), each the
    mean of NOISY_SPP camera waves, as tensors on the scene's device."""
    dev = scene.geo.p0.device
    alb = torch.zeros((w * h, 3), device=dev)
    nrm = torch.zeros((w * h, 3), device=dev)
    dep = torch.zeros((w * h,), device=dev)
    for s in range(NOISY_SPP):
        aux = aov_wave(scene, w, h, seed, s)
        alb = alb + aux.albedo
        nrm = nrm + aux.normal
        dep = dep + aux.depth_t
    alb = alb / NOISY_SPP
    nrm = nrm / torch.clamp_min(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), 1e-6)
    dep = dep / NOISY_SPP
    return alb.reshape(h, w, 3), nrm.reshape(h, w, 3), dep.reshape(h, w)


def recipe_descs(n_scenes=10, seed=42):
    """The scene descriptions of a generation: ``n_scenes - 2`` Cornell
    variants, then (seed 42) veach_mis, the furnace, three bounce-lamp
    and three door_room variants whose parameters leave out the gate
    scenes' (lamp light_scale 30; door 40k triangles, 60 degrees, 6x), or
    (other seeds) two more Cornell variants."""
    rs = np.random.default_rng(seed)
    descs = [rand_cornell(rs) for _ in range(n_scenes - 2)]
    if seed == 42:
        descs.append(veach_mis())
        descs.append(furnace(albedo=0.6, env_radiance=1.2))
        for _ in range(3):
            ls = float(rs.choice([rs.uniform(14, 24), rs.uniform(36, 48)]))
            d = bounce_lamp_room(light_scale=ls)
            cam = [float(rs.uniform(-0.3, 0.3)), float(rs.uniform(0.7, 1.3)), -3.2]
            d["sensor"]["to_world"] = look_at(cam, [0, 1.0, 0])
            descs.append(d)
        for _ in range(3):
            ajar = float(rs.choice([rs.uniform(40, 54), rs.uniform(66, 80)]))
            descs.append(door_room(int(rs.choice([22_000, 30_000])), ajar_deg=ajar,
                                   light_scale=float(rs.uniform(3.0, 10.0))))
    else:
        descs.extend(rand_cornell(rs) for _ in range(2))
    return descs


def render_dataset(descs, res=RES, ref_spp=REF_SPP, n_noisy=N_NOISY, device="cuda", log=print):
    """Render each description: (x (n, res, res, 10) noisy colour, albedo,
    normal, depth; y (n, res, res, 3) the target; the seconds of each
    scene), n = n_noisy a scene."""
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    xs, ys, secs = [], [], []
    for i, desc in enumerate(descs):
        t0 = time.time()
        scene = build_scene(desc, device=device)
        ref = render(scene, RenderConfig(width=res, height=res, spp=ref_spp,
                                         max_depth=RENDER_DEPTH, seed=1000 + i)).cpu().numpy()
        alb, nrm, dep = (a.cpu().numpy() for a in render_aov_buffers(scene, res, res, 7000 + i))
        for j in range(n_noisy):
            noisy = render(scene, RenderConfig(width=res, height=res, spp=NOISY_SPP,
                                               max_depth=RENDER_DEPTH, seed=100 * i + j))
            xs.append(np.concatenate([noisy.cpu().numpy(), alb, nrm, dep[..., None]],
                                     axis=-1).astype(np.float32))
            ys.append(ref.astype(np.float32))
        secs.append(time.time() - t0)
        log(f"scene {i}: {secs[-1]:.1f}s")
    return np.stack(xs), np.stack(ys), secs


def gen_dataset(n_scenes=10, out=None, seed=42, device="cuda", log=print):
    """Render a generation (``recipe_descs``) and write it to ``out``."""
    out = out or data_path()
    x, y, _ = render_dataset(recipe_descs(n_scenes, seed), device=device, log=log)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, x=x, y=y)
    log(f"dataset: {x.shape} -> {out}")
    return out


def load_dataset(data):
    """(x, y) numpy arrays of a dataset file, of every file a glob names
    (in sorted order), or of an (x, y) pair."""
    if not isinstance(data, str):
        return data
    paths = sorted(glob.glob(data)) if "*" in data else [data]
    xs, ys = [], []
    for p in paths:
        with np.load(p) as z:
            xs.append(z["x"])
            ys.append(z["y"])
    return np.concatenate(xs), np.concatenate(ys)


def with_bases(x, device):
    """The dataset's inputs on ``device`` with each image's a-trous base
    (``denoise_hdr``, computed once) as channels 10:13."""
    from mitsuba_path_guiding_torch.film.denoise import denoise_hdr

    X = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
    bases = torch.stack([denoise_hdr(im[..., 0:3], im[..., 3:6], im[..., 6:9], im[..., 9])
                         for im in X])
    return torch.cat([X, bases], dim=-1)


def flip_batch(xb, yb, flip):
    """Mirror the batch entries ``flip`` (B,) bool along W (NHWC); a
    mirrored normal's x changes sign."""
    sign = torch.ones(xb.shape[-1], device=xb.device)
    sign[NORMAL_X] = -1.0
    f = flip[:, None, None, None]
    return torch.where(f, xb.flip(2) * sign, xb), torch.where(f, yb.flip(2), yb)


def draw_batch(X, Y, gen, batch, crop):
    """``batch`` random crops of ``crop`` x ``crop`` pixels, each flipped
    with probability 1/2, all drawn on the data's device from ``gen``."""
    n, h, w = X.shape[:3]
    dev = X.device
    idx = torch.randint(0, n, (batch,), generator=gen, device=dev)
    ox = torch.randint(0, w - crop, (batch,), generator=gen, device=dev)
    oy = torch.randint(0, h - crop, (batch,), generator=gen, device=dev)
    flip = torch.rand((batch,), generator=gen, device=dev) < 0.5
    r = torch.arange(crop, device=dev)
    rows = (oy[:, None] + r)[:, :, None]
    cols = (ox[:, None] + r)[:, None, :]
    i = idx[:, None, None]
    return flip_batch(X[i, rows, cols], Y[i, rows, cols], flip)


def prep(xb, yb):
    """(the net's input, the demodulated log base, the demodulated log
    target) of an NHWC batch of dataset inputs with bases and targets."""
    xin, demob, alb = nd.pack_inputs(xb[..., 0:3], xb[..., 10:13], xb[..., 3:6], xb[..., 6:9],
                                     xb[..., 9])
    return xin, demob, torch.log1p(torch.clamp_min(yb, 0.0) / alb)


def log_loss(out_log, y_log):
    """L1 plus half the finite-difference gradient terms (W, then H) in
    demodulated log space, NHWC."""
    l1 = (out_log - y_log).abs().mean()
    gx = (torch.diff(out_log, dim=2) - torch.diff(y_log, dim=2)).abs().mean()
    gy = (torch.diff(out_log, dim=1) - torch.diff(y_log, dim=1)).abs().mean()
    return l1 + 0.5 * (gx + gy)


def net_residual(net):
    """A DenoiserNet as a map of NHWC inputs to NHWC residuals."""
    return lambda x: net(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


def loss_fn(residual, xb, yb):
    """The training loss of ``residual`` (NHWC -> NHWC) on a batch."""
    xin, demob, y_log = prep(xb, yb)
    return log_loss(torch.clamp_min(demob + residual(xin), 0.0), y_log)


def zero_residual_loss(xb, yb):
    """The loss of the a-trous base alone (a residual of zeros)."""
    _, demob, y_log = prep(xb, yb)
    return log_loss(torch.clamp_min(demob + torch.zeros_like(demob), 0.0), y_log)


def lr_at(count: int, lr: float, steps: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, max(steps // 20, 50),
    steps) at ``count``: linear from 0 over the warmup, then a cosine to 0
    over the remaining steps."""
    warmup = max(steps // 20, 50)
    if count < warmup:
        return lr * count / warmup
    decay = steps - warmup
    c = min(count - warmup, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))


class Adam:
    """optax.adam: moments (1 - b) g + b m, bias-corrected by the update's
    count, eps outside the square root; the learning rate is given at
    each step (the schedule at the count before the update)."""

    def __init__(self, params, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads, lr: float):
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.copy_((1.0 - self.b1) * g + self.b1 * m)
            v.copy_((1.0 - self.b2) * (g * g) + self.b2 * v)
            p.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps)))


def deterministic():
    """cuDNN with deterministic algorithms, no autotuning and no TF32, for
    the forward and the backward."""
    return torch.backends.cudnn.flags(enabled=True, deterministic=True, benchmark=False,
                                      allow_tf32=False)


def train(data, steps=3000, batch=8, crop=64, lr=2e-3, seed=0, device="cuda", out=None,
          log=print):
    """Train from seed ``seed`` on ``data`` (``load_dataset``'s argument)
    on ``device``; write the weights to ``out`` when given.  Returns (the
    DenoiserNet, a record: the loss at each print step, the step-0 loss
    and the zero-residual loss of the same batch, seconds, steps/s)."""
    dev = torch.device(device)
    x, y = load_dataset(data)
    X = with_bases(x, dev)
    Y = torch.as_tensor(np.ascontiguousarray(y, np.float32), device=dev)
    log(f"dataset: {tuple(X.shape)} images")
    params = nd.init_params(torch.Generator(dev).manual_seed(seed))
    log(f"params: {nd.n_params(params) / 1e3:.1f}k")
    net = nd.DenoiserNet(params).to(dev)
    weights = list(net.parameters())
    opt = Adam(weights)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    residual = net_residual(net)
    rec = {"steps": steps, "batch": batch, "crop": crop, "lr": lr, "seed": seed,
           "images": int(X.shape[0]), "losses": {}}
    t0 = time.time()
    with deterministic():
        for i in range(steps):
            xb, yb = draw_batch(X, Y, gen, batch, crop)
            loss = loss_fn(residual, xb, yb)
            grads = torch.autograd.grad(loss, weights)
            loss = loss.detach()
            if i == 0:
                rec["loss0"] = float(loss)
                rec["loss0_zero_residual"] = float(zero_residual_loss(xb, yb))
            opt.step(grads, lr_at(i, lr, steps))
            if i % PRINT_EVERY == 0 or i == steps - 1:
                rec["losses"][i] = float(loss)
                log(f"step {i}: loss {rec['losses'][i]:.4f}  ({time.time() - t0:.0f}s)")
    rec["seconds"] = time.time() - t0
    rec["steps_per_s"] = steps / rec["seconds"]
    if out:
        nd.save_params(net.params(), out)
        log(f"wrote {out} ({os.path.getsize(out) / 1024:.0f} KB)")
    return net, rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", nargs="?", default="3000", help="gen1, gen2, gen3 or a step count")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.what in GENERATIONS:
        n, seed, suffix = GENERATIONS[args.what]
        gen_dataset(n_scenes=n, out=data_path(suffix), seed=seed, device=args.device)
        return 0
    if not os.path.exists(data_path()):
        gen_dataset(device=args.device)
    train(os.environ.get("DN_DATA", data_path("*")), steps=int(args.what),
          seed=int(os.environ.get("DN_SEED", "0")), device=args.device,
          out=os.environ.get("DN_OUT", DEFAULT_OUT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
