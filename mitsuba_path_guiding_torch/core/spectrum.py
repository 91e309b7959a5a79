"""RGB luminance and the sRGB transfer curve (port of the reference's
core/spectrum.py, the parts the port uses)."""
from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.709 luminance weights, float32 as in the reference (the scene
# compiler's emitter powers are computed from these exact values)
LUM_WEIGHTS_NP = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)


# the same float32 values as Python scalars: a product with a scalar needs
# no copy of the weights to the card (a host sync there)
_W0, _W1, _W2 = (float(x) for x in LUM_WEIGHTS_NP)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return rgb[..., 0] * _W0 + rgb[..., 1] * _W1 + rgb[..., 2] * _W2



def srgb_encode_np(linear):
    """Linear -> sRGB transfer on the host (numpy), for 8-bit output."""
    linear = np.clip(linear, 0.0, 1.0)
    return np.where(linear <= 0.0031308, 12.92 * linear,
                    1.055 * np.power(np.maximum(linear, 1e-8), 1.0 / 2.4) - 0.055)
