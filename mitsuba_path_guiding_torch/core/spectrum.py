"""RGB luminance, colour-space conversions, the sRGB transfer curve and
Reinhard's tonemap (port of the reference's core/spectrum.py)."""
from __future__ import annotations

import numpy as np
import torch

# ITU-R BT.709 luminance weights, float32 as in the reference (the scene
# compiler's emitter powers are computed from these exact values)
LUM_WEIGHTS_NP = np.array([0.212671, 0.715160, 0.072169], dtype=np.float32)
LUM_WEIGHTS = torch.from_numpy(LUM_WEIGHTS_NP)

# linear sRGB (D65) <-> CIE XYZ
_RGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                        [0.212671, 0.715160, 0.072169],
                        [0.019334, 0.119193, 0.950227]], dtype=np.float32)
_XYZ_TO_RGB = np.array([[3.240479, -1.537150, -0.498535],
                        [-0.969256, 1.875991, 0.041556],
                        [0.055648, -0.204043, 1.057311]], dtype=np.float32)


# the same float32 values as Python scalars: a product with a scalar needs
# no copy of the weights to the card (a host sync there)
_W0, _W1, _W2 = (float(x) for x in LUM_WEIGHTS_NP)


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    return rgb[..., 0] * _W0 + rgb[..., 1] * _W1 + rgb[..., 2] * _W2


def _apply3(m: np.ndarray, v: torch.Tensor) -> torch.Tensor:
    """v @ m.T with the matrix's entries as scalars."""
    return torch.stack([v[..., 0] * float(r[0]) + v[..., 1] * float(r[1]) + v[..., 2] * float(r[2])
                        for r in m], dim=-1)


def rgb_to_xyz(rgb: torch.Tensor) -> torch.Tensor:
    return _apply3(_RGB_TO_XYZ, rgb)


def xyz_to_rgb(xyz: torch.Tensor) -> torch.Tensor:
    return _apply3(_XYZ_TO_RGB, xyz)


def srgb_encode(linear: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB transfer, clamped to [0, 1]."""
    linear = torch.clamp(linear, 0.0, 1.0)
    return torch.where(linear <= 0.0031308, 12.92 * linear,
                       1.055 * torch.pow(torch.clamp_min(linear, 1e-8), 1.0 / 2.4) - 0.055)


def srgb_decode(srgb: torch.Tensor) -> torch.Tensor:
    """sRGB -> linear transfer."""
    return torch.where(srgb <= 0.04045, srgb / 12.92,
                       torch.pow((srgb + 0.055) / 1.055, 2.4))


def max_component(rgb: torch.Tensor) -> torch.Tensor:
    return torch.amax(rgb, dim=-1)


def reinhard_tonemap(rgb: torch.Tensor, key: float = 0.18, burn: float = 0.0) -> torch.Tensor:
    """Photographic tonemapping (Mitsuba's tonemap utility): scale to the
    log-average luminance ``key``, then compress as ``L / (1 + L)``; with
    ``burn`` > 0 as ``L (1 + L / Lwhite^2) / (1 + L)``, Lwhite the largest
    scaled luminance of the image."""
    lum = luminance(rgb)
    log_avg = torch.exp(torch.mean(torch.log(torch.clamp_min(lum, 1e-6))))
    scaled = rgb * (key / torch.clamp_min(log_avg, 1e-12))
    lw = luminance(scaled)
    if burn > 0:
        lwhite2 = torch.clamp_min(torch.amax(lw), 1e-6) ** 2
        ld = lw * (1.0 + lw / lwhite2) / (1.0 + lw)
    else:
        ld = lw / (1.0 + lw)
    return scaled * (ld / torch.clamp_min(lw, 1e-12))[..., None]


def srgb_encode_np(linear):
    """Linear -> sRGB transfer on the host (numpy), for 8-bit output."""
    linear = np.clip(linear, 0.0, 1.0)
    return np.where(linear <= 0.0031308, 12.92 * linear,
                    1.055 * np.power(np.maximum(linear, 1e-8), 1.0 / 2.4) - 0.055)
