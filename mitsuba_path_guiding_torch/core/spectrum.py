"""RGB luminance and the sRGB transfer curve (port of the reference's
core/spectrum.py, the parts the port uses)."""
from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.709 luminance weights, float32 as in the reference (the scene
# compiler's emitter powers are computed from these exact values)
LUM_WEIGHTS_NP = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    w = torch.as_tensor(LUM_WEIGHTS_NP, device=rgb.device)
    return rgb[..., 0] * w[0] + rgb[..., 1] * w[1] + rgb[..., 2] * w[2]



def srgb_encode_np(linear):
    """Linear -> sRGB transfer on the host (numpy), for 8-bit output."""
    linear = np.clip(linear, 0.0, 1.0)
    return np.where(linear <= 0.0031308, 12.92 * linear,
                    1.055 * np.power(np.maximum(linear, 1e-8), 1.0 / 2.4) - 0.055)
