"""Arithmetic of the end-to-end metrics: the relative variance of an image
estimated from two half-images, without a reference image, and
percentiles of latencies."""
import numpy as np
import torch

TARGET_RELVAR = 0.01
TRIM = 0.001      # share of the worst pixels left out
REG = 0.1         # regulariser, a share of the image's mean


def relvar_from_halves(a, b):
    """Relative variance of the image (a + b) / 2 from its halves a and b
    (P, C) or (H, W, C): per pixel ((a - b) / 2)^2 over ((a + b) / 2)^2 +
    (0.1 mean)^2, averaged over the channels, then over the pixels but the
    worst 0.1%."""
    a = torch.as_tensor(a).double().reshape(-1, a.shape[-1])
    b = torch.as_tensor(b).double().reshape(-1, b.shape[-1])
    mean_img = (a + b) / 2
    m = mean_img.mean()
    per_px = (((a - b) / 2) ** 2 / (mean_img ** 2 + (REG * m) ** 2)).mean(-1)
    keep = per_px.shape[0] - int(per_px.shape[0] * TRIM)
    return float(torch.sort(per_px).values[:keep].mean())


def time_to_noise(window_s, relvar):
    """Seconds to bring the image to a relative variance of 0.01, for a
    variance that falls as one over the time rendered."""
    return window_s * relvar / TARGET_RELVAR


def percentile(values, q):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
