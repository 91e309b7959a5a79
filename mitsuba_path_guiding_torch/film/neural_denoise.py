"""Neural denoiser: a small U-Net over albedo-demodulated log radiance
with albedo, normal and depth feature buffers (port of the reference's
film/neural_denoise.py, inference only).

The network refines the a-trous filter's result (``film/denoise.py``
``denoise_hdr``): its output is a residual over the demodulated log of
that base, clipped to +-0.35, so its worst case is the classical filter.
Eleven 3x3 convolutions (``_conv_spec``) in an encoder of three levels
(two of them at stride 2) and a decoder with nearest 2x upsampling and
skip connections.  The weights are the reference's trained ones, float16
in ``data/denoiser_weights.npz`` (HWIO), float32 here (OIHW).

The convolutions reproduce XLA's "SAME" padding: a stride-2 layer on an
even size pads 0 before and 1 after (``F.conv2d``'s symmetric padding
would shift the grid), and the input is padded to a multiple of 4 by
repeating its edge.  cuDNN may compute float32 convolutions in TF32, so
the net runs with TF32 off.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

CH = (24, 48, 80)      # channels per U-Net level
# the demodulated log colour (3), the demodulated log a-trous base (3),
# albedo (3), normal (3) and log depth (1)
IN_CH = 13
ALBEDO_EPS = 1e-3
RES_CLIP = 0.35
_WEIGHTS_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "data", "denoiser_weights.npz")


def _conv_spec():
    """[(name, k, cin, cout, stride)] of the network."""
    c1, c2, c3 = CH
    return [
        ("e1a", 3, IN_CH, c1, 1), ("e1b", 3, c1, c1, 1),
        ("e2a", 3, c1, c2, 2), ("e2b", 3, c2, c2, 1),
        ("e3a", 3, c2, c3, 2), ("e3b", 3, c3, c3, 1),
        ("d2a", 3, c3 + c2, c2, 1), ("d2b", 3, c2, c2, 1),
        ("d1a", 3, c2 + c1, c1, 1), ("d1b", 3, c1, c1, 1),
        ("out", 3, c1, 3, 1),
    ]


def _same_pad(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one axis: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class DenoiserNet(torch.nn.Module):
    """The U-Net on (N, IN_CH, H, W), H and W multiples of 4 -> the
    residual (N, 3, H, W)."""

    def __init__(self, params: dict):
        super().__init__()
        self.spec = _conv_spec()
        for name, k, cin, cout, _ in self.spec:
            w = torch.as_tensor(np.asarray(params[name + "_w"], np.float32))
            if tuple(w.shape) != (k, k, cin, cout):
                raise ValueError(f"{name}_w: shape {tuple(w.shape)}, expected {(k, k, cin, cout)}")
            self.register_buffer(name + "_w", w.permute(3, 2, 0, 1).contiguous())  # HWIO -> OIHW
            self.register_buffer(name + "_b", torch.as_tensor(
                np.asarray(params[name + "_b"], np.float32)))

    def _conv(self, name, x, stride=1):
        w = getattr(self, name + "_w")
        k = w.shape[-1]
        top, bottom = _same_pad(x.shape[2], k, stride)
        left, right = _same_pad(x.shape[3], k, stride)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, w, stride=stride) + getattr(self, name + "_b")[:, None, None]

    @staticmethod
    def _up2(x):
        return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    def forward(self, x):
        c, r = self._conv, F.relu
        e1 = r(c("e1b", r(c("e1a", x))))
        e2 = r(c("e2b", r(c("e2a", e1, 2))))
        e3 = r(c("e3b", r(c("e3a", e2, 2))))
        d2 = torch.cat([self._up2(e3), e2], dim=1)
        d2 = r(c("d2b", r(c("d2a", d2))))
        d1 = torch.cat([self._up2(d2), e1], dim=1)
        d1 = r(c("d1b", r(c("d1a", d1))))
        return c("out", d1)


def pack_inputs(color, base, albedo, normal, depth):
    """(H, W, 3) colour, base, albedo, normal and (H, W) depth -> the
    (H, W, IN_CH) network input, the demodulated log base the output is a
    residual over, and the clamped albedo."""
    alb = torch.clamp_min(albedo, ALBEDO_EPS)
    demod = torch.log1p(torch.clamp_min(color, 0.0) / alb)
    demob = torch.log1p(torch.clamp_min(base, 0.0) / alb)
    dep = torch.log1p(torch.clamp_min(depth, 0.0))[..., None]
    x = torch.cat([demod, demob, albedo, normal, dep], dim=-1)
    return x, demob, alb


def denoise_neural_net(net: DenoiserNet, color, albedo, normal, depth):
    """Denoise one (H, W, 3) HDR image with its feature buffers."""
    from mitsuba_path_guiding_torch.film.denoise import denoise_hdr

    base = denoise_hdr(color, albedo, normal, depth)
    h, w = color.shape[:2]
    x, demob, alb = pack_inputs(color, base, albedo, normal, depth)
    x = x.permute(2, 0, 1)[None]  # (1, IN_CH, H, W)
    x = F.pad(x, (0, (-w) % 4, 0, (-h) % 4), mode="replicate")
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
        res = net(x)[0, :, :h, :w].permute(1, 2, 0)
    out_log = torch.clamp_min(demob + torch.clamp(res, -RES_CLIP, RES_CLIP), 0.0)
    return torch.expm1(out_log) * alb


def load_params(path: str | None = None):
    """The weights file (float16) as a dict of float32 numpy arrays, or
    None where it is missing."""
    p = path or _WEIGHTS_FILE
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


_NETS: dict = {}


def load_net(device=None, path: str | None = None):
    """The DenoiserNet of the weights file on ``device`` (cached), or None
    where the file is missing."""
    key = (str(torch.device(device or "cpu")), path)
    if key not in _NETS:
        params = load_params(path)
        _NETS[key] = None if params is None else DenoiserNet(params).to(device)
    return _NETS[key]


def denoise_neural(color, albedo, normal, depth):
    """Denoise with the weights in the package; the a-trous filter where
    the weights file is missing."""
    net = load_net(color.device)
    if net is None:
        from mitsuba_path_guiding_torch.film.denoise import denoise_hdr

        return denoise_hdr(color, albedo, normal, depth)
    return denoise_neural_net(net, color, albedo, normal, depth)
