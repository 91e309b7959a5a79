"""Feature-guided denoiser: edge-avoiding a-trous wavelet filtering (port
of the reference's film/denoise.py).

Color plus albedo, normal and depth feature buffers in, the denoised
image out: a few 5x5 dilated passes with bilateral weights from the
feature buffers (Dammertz et al. 2010).  Shifts are zero-padded: a roll
whose wrapped border is zeroed and carries no weight.  ``denoise_hdr``
suppresses fireflies and filters in log space; ``prefilter_features``
cleans noisy feature buffers; ``render_aovs`` averages a progressive
renderer's first-hit buffers; ``denoise_with_aux`` is the CLI's step,
the neural denoiser (``film/neural_denoise.py``) over those buffers.
Every function runs on the device of its inputs.
"""
from __future__ import annotations

import numpy as np
import torch

# the 5-tap B3 spline kernel (separable)
_K1D = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]


def _shift2d(x, dy, dx):
    """Zero-padded 2D shift of (H, W, C) or (H, W): (shifted, valid as
    float32, (H, W, 1) or (H, W))."""
    out = torch.roll(x, shifts=(dy, dx), dims=(0, 1))
    h, w = x.shape[0], x.shape[1]
    ys = torch.arange(h, device=x.device)[:, None]
    xs = torch.arange(w, device=x.device)[None, :]
    valid = (ys - dy >= 0) & (ys - dy < h) & (xs - dx >= 0) & (xs - dx < w)
    if x.dim() == 3:
        valid = valid[..., None]
    return torch.where(valid, out, 0.0), valid.to(torch.float32)


def firefly_suppress(color: torch.Tensor, k: float = 4.0) -> torch.Tensor:
    """Clamp outlier pixels to k times their 3x3 neighbourhood's mean
    (itself excluded): a few firefly pixels would otherwise carry most of
    the a-trous filter's error."""
    s = torch.zeros_like(color)
    w = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            sh, valid = _shift2d(color, dy, dx)
            s = s + sh
            w = w + valid
    nb_mean = s / torch.clamp_min(w, 1.0)
    lum = color.sum(-1, keepdim=True)
    nb_lum = nb_mean.sum(-1, keepdim=True)
    scale = torch.where(lum > k * nb_lum + 1e-6,
                        (k * nb_lum + 1e-6) / torch.clamp_min(lum, 1e-12), 1.0)
    return color * scale


def denoise_hdr(color, albedo, normal, depth, iterations: int = 3, sigma_color: float = 1.0,
                **kw):
    """Firefly suppression, then the a-trous filter in log space."""
    c = firefly_suppress(color)
    out = atrous_denoise(torch.log1p(c), albedo, normal, depth, iterations=iterations,
                         sigma_color=sigma_color, **kw)
    return torch.expm1(out)


def atrous_denoise(color, albedo, normal, depth, iterations: int = 4, sigma_color: float = 0.45,
                   sigma_albedo: float = 0.15, sigma_normal: float = 16.0,
                   sigma_depth: float = 0.35):
    """Denoise (H, W, 3) radiance with (H, W, 3) albedo and normal and
    (H, W) depth buffers."""
    c = color
    zext = torch.clamp_min(depth.max() - depth.min(), 1e-6)
    zn = depth / zext
    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(c)
        wacc = torch.zeros(c.shape[:2] + (1,), dtype=c.dtype, device=c.device)
        for iy in range(-2, 3):
            for ix in range(-2, 3):
                h = float(_K1D[iy + 2] * _K1D[ix + 2])
                dy, dx = iy * step, ix * step
                cq, vq = _shift2d(c, dy, dx)
                aq, _ = _shift2d(albedo, dy, dx)
                nq, _ = _shift2d(normal, dy, dx)
                zq, _ = _shift2d(zn, dy, dx)
                vq1 = vq if vq.dim() == 3 else vq[..., None]

                dc = torch.sum((c - cq) ** 2, dim=-1, keepdim=True)
                w_c = torch.exp(-dc / (sigma_color * sigma_color * (step ** 0.5)))
                da = torch.sum((albedo - aq) ** 2, dim=-1, keepdim=True)
                w_a = torch.exp(-da / (sigma_albedo * sigma_albedo))
                ndot = torch.clamp(torch.sum(normal * nq, dim=-1, keepdim=True), 0.0, 1.0)
                w_n = ndot ** sigma_normal
                dz = torch.abs(zn - zq)[..., None]
                w_z = torch.exp(-dz / sigma_depth)

                w = h * w_c * w_a * w_n * w_z * vq1
                acc = acc + cq * w
                wacc = wacc + w
        c = acc / torch.clamp_min(wacc, 1e-8)
    return c


def prefilter_features(albedo, normal, depth, iterations: int = 2):
    """Light cross-filtering of noisy feature buffers."""
    a = atrous_denoise(albedo, albedo, normal, depth, iterations=iterations)
    n = atrous_denoise(normal, albedo, normal, depth, iterations=iterations)
    n = n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-6)
    return a, n


def render_aovs(renderer, spp: int = 4):
    """Albedo, normal and depth feature buffers averaged over ``spp``
    waves of a progressive renderer, from its current sample index on (no
    records, the grid untouched): {"albedo": (H, W, 3), "normal": (H, W,
    3), "depth": (H, W, 1)}."""
    r = renderer.cfg.render
    n_pix = r.width * r.height
    dev = renderer.device
    pix = torch.arange(n_pix, dtype=torch.int64, device=dev)
    alb = torch.zeros((n_pix, 3), device=dev)
    nrm = torch.zeros((n_pix, 3), device=dev)
    dep = torch.zeros((n_pix,), device=dev)
    for s in range(spp):
        sidx = torch.full_like(pix, renderer.sample_counter + s)
        _, _, aux, _ = renderer._wave(pix, sidx, train=False)
        alb = alb + aux.albedo
        nrm = nrm + aux.normal
        dep = dep + aux.depth_t
    alb = alb / spp
    nrm = nrm / torch.clamp_min(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), 1e-6)
    dep = dep / spp
    return {"albedo": alb.reshape(r.height, r.width, 3),
            "normal": nrm.reshape(r.height, r.width, 3),
            "depth": dep.reshape(r.height, r.width, 1)}


def denoise_with_aux(renderer, img):
    """The CLI's denoising step: render the feature buffers and run the
    neural denoiser (the a-trous filter where its weights are missing) on
    a finished image.  Returns (the denoised image as numpy, the AOVs)."""
    from mitsuba_path_guiding_torch.film.neural_denoise import denoise_neural

    aovs = render_aovs(renderer)
    color = torch.as_tensor(np.asarray(img, np.float32), device=renderer.device)
    out = denoise_neural(color, aovs["albedo"], aovs["normal"], aovs["depth"][..., 0])
    return out.cpu().numpy(), aovs
