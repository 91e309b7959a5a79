"""Neural denoiser: a small U-Net over albedo-demodulated log radiance
with albedo, normal and depth feature buffers (port of the reference's
film/neural_denoise.py: the net, its initialisation and its functional
form for training, ``film/train_denoiser.py``).

The network refines the a-trous filter's result (``film/denoise.py``
``denoise_hdr``): its output is a residual over the demodulated log of
that base, clipped to +-0.35, so its worst case is the classical filter.
Eleven 3x3 convolutions (``_conv_spec``) in an encoder of three levels
(two of them at stride 2) and a decoder with nearest 2x upsampling and
skip connections.  The weights are the reference's trained ones, float16
in ``data/denoiser_weights.npz`` (HWIO); ``DenoiserNet`` holds them as
float32 parameters (OIHW), and ``params`` dicts hold them as float32
HWIO tensors, the reference's layout.

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


def init_params(generator: torch.Generator) -> dict:
    """He-normal weights std sqrt(2 / (k k cin)) in HWIO, zero biases, and
    a zero ``out`` head, drawn on the generator's device.  The zero head
    makes the untrained net the identity over the a-trous base, so
    training descends from the classical filter (the reference found
    seeds with a noisy head collapsing into the zero-residual minimum)."""
    dev = generator.device
    params = {}
    for name, k, cin, cout, _ in _conv_spec():
        w = torch.randn((k, k, cin, cout), generator=generator, device=dev) * float(
            np.sqrt(2.0 / (k * k * cin)))
        if name == "out":
            w = torch.zeros_like(w)
        params[name + "_w"] = w
        params[name + "_b"] = torch.zeros((cout,), device=dev)
    return params


def n_params(params) -> int:
    return int(sum(np.prod(tuple(v.shape)) for v in params.values()))


def _conv(w, b, x, stride=1):
    """One "SAME" convolution of NCHW ``x`` with OIHW ``w``."""
    k = w.shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride) + b[:, None, None]


def _up2(x):
    """Nearest 2x upsampling of NCHW ``x`` (a broadcast, so its backward is
    a sum and not an index_add)."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2).reshape(n, c, 2 * h, 2 * w)


def _unet(conv, x):
    """The U-Net on NCHW ``x``; ``conv(name, x, stride)`` is one layer."""
    r = F.relu
    e1 = r(conv("e1b", r(conv("e1a", x))))
    e2 = r(conv("e2b", r(conv("e2a", e1, 2))))
    e3 = r(conv("e3b", r(conv("e3a", e2, 2))))
    d2 = torch.cat([_up2(e3), e2], dim=1)
    d2 = r(conv("d2b", r(conv("d2a", d2))))
    d1 = torch.cat([_up2(d2), e1], dim=1)
    d1 = r(conv("d1b", r(conv("d1a", d1))))
    return conv("out", d1)


def _f32(v) -> torch.Tensor:
    """A numpy array or tensor as a float32 tensor (tensors keep their
    device)."""
    return v.detach().float() if torch.is_tensor(v) else torch.from_numpy(np.array(v, np.float32))


class DenoiserNet(torch.nn.Module):
    """The U-Net on (N, IN_CH, H, W), H and W multiples of 4 -> the
    residual (N, 3, H, W); its weights are trainable parameters."""

    def __init__(self, params: dict):
        super().__init__()
        self.spec = _conv_spec()
        for name, k, cin, cout, _ in self.spec:
            w, b = _f32(params[name + "_w"]), _f32(params[name + "_b"])
            if tuple(w.shape) != (k, k, cin, cout):
                raise ValueError(f"{name}_w: shape {tuple(w.shape)}, expected {(k, k, cin, cout)}")
            # HWIO -> OIHW
            self.register_parameter(name + "_w", torch.nn.Parameter(
                w.permute(3, 2, 0, 1).contiguous()))
            self.register_parameter(name + "_b", torch.nn.Parameter(b.clone()))

    def forward(self, x):
        return _unet(lambda name, y, stride=1: _conv(
            getattr(self, name + "_w"), getattr(self, name + "_b"), y, stride), x)

    def params(self) -> dict:
        """The weights as a params dict (float32 HWIO, detached)."""
        out = {}
        for name, *_ in self.spec:
            out[name + "_w"] = getattr(self, name + "_w").detach().permute(2, 3, 1, 0)
            out[name + "_b"] = getattr(self, name + "_b").detach()
        return out


def _apply_nchw(params: dict, x):
    """HWIO ``params`` on NCHW ``x``."""
    def conv(name, y, stride=1):
        return _conv(params[name + "_w"].permute(3, 2, 0, 1), params[name + "_b"], y, stride)

    return _unet(conv, x)


def apply_net(params: dict, x):
    """The reference's functional net: HWIO ``params``, x (N, H, W,
    IN_CH) -> residual (N, H, W, 3); H, W multiples of 4."""
    return _apply_nchw(params, x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)


def pack_inputs(color, base, albedo, normal, depth):
    """(..., 3) colour, base, albedo, normal and (...) depth -> the
    (..., IN_CH) network input, the demodulated log base the output is a
    residual over, and the clamped albedo."""
    alb = torch.clamp_min(albedo, ALBEDO_EPS)
    demod = torch.log1p(torch.clamp_min(color, 0.0) / alb)
    demob = torch.log1p(torch.clamp_min(base, 0.0) / alb)
    dep = torch.log1p(torch.clamp_min(depth, 0.0))[..., None]
    x = torch.cat([demod, demob, albedo, normal, dep], dim=-1)
    return x, demob, alb


def _denoise(residual, color, albedo, normal, depth):
    """Denoise one (H, W, 3) HDR image with ``residual``, a function of the
    padded (1, IN_CH, H', W') input giving (1, 3, H', W')."""
    from mitsuba_path_guiding_torch.film.denoise import denoise_hdr

    base = denoise_hdr(color, albedo, normal, depth)
    h, w = color.shape[:2]
    x, demob, alb = pack_inputs(color, base, albedo, normal, depth)
    x = x.permute(2, 0, 1)[None]  # (1, IN_CH, H, W)
    x = F.pad(x, (0, (-w) % 4, 0, (-h) % 4), mode="replicate")
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=False):
        res = residual(x)[0, :, :h, :w].permute(1, 2, 0)
    out_log = torch.clamp_min(demob + torch.clamp(res, -RES_CLIP, RES_CLIP), 0.0)
    return torch.expm1(out_log) * alb


def denoise_neural_net(net: DenoiserNet, color, albedo, normal, depth):
    """Denoise one (H, W, 3) HDR image with its feature buffers."""
    return _denoise(net, color, albedo, normal, depth)


def denoise_neural_params(params: dict, color, albedo, normal, depth):
    """``denoise_neural_net`` with HWIO ``params`` (on the image's device)."""
    return _denoise(lambda x: _apply_nchw(params, x), color, albedo, normal, depth)


def save_params(params: dict, path: str):
    """Write HWIO ``params`` as the weights file: float16 arrays under the
    22 names of the checked-in file, which the reference's ``load_params``
    reads too."""
    want = [n + s for n, *_ in _conv_spec() for s in ("_w", "_b")]
    if sorted(params) != sorted(want):
        raise ValueError(f"params: keys {sorted(params)}, expected {sorted(want)}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **{k: np.asarray(
        v.detach().cpu().numpy() if torch.is_tensor(v) else v, np.float32).astype(np.float16)
        for k, v in params.items()})


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
    """The DenoiserNet of the weights file on ``device`` (cached, its
    parameters frozen), or None where the file is missing."""
    key = (str(torch.device(device or "cpu")), path)
    if key not in _NETS:
        params = load_params(path)
        _NETS[key] = None if params is None else DenoiserNet(params).requires_grad_(False).to(
            device)
    return _NETS[key]


def denoise_neural(color, albedo, normal, depth):
    """Denoise with the weights in the package; the a-trous filter where
    the weights file is missing."""
    net = load_net(color.device)
    if net is None:
        from mitsuba_path_guiding_torch.film.denoise import denoise_hdr

        return denoise_hdr(color, albedo, normal, depth)
    return denoise_neural_net(net, color, albedo, normal, depth)
