"""Quasi-Monte-Carlo point sets: radical inverse, Halton with
Cranley-Patterson rotations, stratified jitter and Owen-scrambled Sobol'
(port of the reference's core/qmc.py, bit-equal to it).

Counter-based, as in the reference: the s-th sample of pixel p takes the
point at index s, shifted by a hash of the pixel, so sequences are
deterministic and continue across progressive passes.  The Sobol'
direction numbers are Joe & Kuo's (2008), read from the port's own
``data/sobol_joekuo.npz``.

The reference computes in uint32.  PyTorch on the CPU has few uint32
operations, so the words are int64 tensors holding uint32 values, masked
to 32 bits after every shift, add and multiply (as ``core/rng.py`` does
for threefry); a 32-bit product is formed from 16-bit halves so that no
int64 product overflows.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch

from mitsuba_path_guiding_torch.core import rng as rng_mod

MASK32 = 0xFFFFFFFF
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)
_SOBOL_BITS = 30
_SOBOL_MASK = (1 << _SOBOL_BITS) - 1
_TABLE: dict = {}


def radical_inverse(base: int, idx: torch.Tensor) -> torch.Tensor:
    """Van der Corput radical inverse in ``base`` of uint32 indices.

    The reference's float32 loop, as XLA compiles it on the CPU: the
    division of the digit weight by ``base`` becomes a multiply by the
    float32 reciprocal, and ``val + digit * inv`` one fused multiply-add.
    The FMA is formed in float64 (the product of a digit and a float32
    weight is exact there) and rounded once to float32."""
    n_digits = 1
    m = base
    while m < (1 << 32):
        n_digits += 1
        m *= base
    i = idx.to(torch.int64)
    val = torch.zeros(idx.shape, dtype=torch.float64, device=idx.device)
    inv = np.float32(1.0 / base)
    rcp = np.float32(1.0 / base)
    for _ in range(n_digits):
        val = (val + (i % base).to(torch.float64) * float(inv)).to(torch.float32).to(torch.float64)
        inv = inv * rcp
        i = torch.div(i, base, rounding_mode="floor")
    return torch.clamp_max(val.to(torch.float32), 1.0 - 1e-7)


def halton_point(dim: int, idx: torch.Tensor) -> torch.Tensor:
    """dim-th coordinate of the idx-th Halton point."""
    return radical_inverse(PRIMES[dim % len(PRIMES)], idx)


def cp_rotate(u: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Cranley-Patterson torus rotation."""
    return torch.remainder(u + shift, 1.0)


def halton_2d(sample_idx: torch.Tensor, pixel_shift: torch.Tensor) -> torch.Tensor:
    """(N, 2) Halton(2, 3) points rotated by the per-pixel ``pixel_shift``."""
    h = torch.stack([halton_point(0, sample_idx), halton_point(1, sample_idx)], dim=-1)
    return cp_rotate(h, pixel_shift)


def stratified_2d(sample_idx: torch.Tensor, n_total: int, jitter: torch.Tensor) -> torch.Tensor:
    """(N, 2) jitter on a k x k grid, k = floor(sqrt(n_total)); indices
    past the grid wrap, so a progressive render adds whole grids."""
    k = max(int(math.floor(math.sqrt(max(n_total, 1)))), 1)
    cell = sample_idx.to(torch.int64) % (k * k)
    cx = (cell % k).to(torch.float32)
    cy = torch.div(cell, k, rounding_mode="floor").to(torch.float32)
    return torch.stack([(cx + jitter[..., 0]) / k, (cy + jitter[..., 1]) / k], dim=-1)


def sobol_direction_numbers(n_dims: int, device=None) -> torch.Tensor:
    """(n_dims, 30) direction numbers (uint32 values in int64, MSB-aligned
    to 2^30) from ``data/sobol_joekuo.npz``."""
    if "sv" not in _TABLE:
        path = os.path.join(os.path.dirname(__file__), "..", "data", "sobol_joekuo.npz")
        _TABLE["sv"] = np.load(path)["sv"].astype(np.int64)
    table = _TABLE["sv"]
    if n_dims > table.shape[0]:
        raise ValueError(f"sobol: {n_dims} dims requested, the table has {table.shape[0]}")
    return torch.as_tensor(table[:n_dims], device=device)


def sobol_bits(idx: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """Raw Sobol' digits: (N, D) words aligned to 2^30."""
    i = idx.to(torch.int64) & MASK32
    acc = torch.zeros(i.shape + (sv.shape[0],), dtype=torch.int64, device=i.device)
    for k in range(_SOBOL_BITS):
        bit = (i >> k) & 1
        acc = acc ^ (bit[..., None] * sv[None, :, k])
    return acc


def _to_unit(bits: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.clamp_max(bits.to(torch.float32) * scale, 1.0 - 1e-7)


def sobol_point(idx: torch.Tensor, sv: torch.Tensor, shift_bits=None) -> torch.Tensor:
    """(N, D) Sobol' points in [0, 1), digitally shifted (XOR) by
    ``shift_bits`` ((N, D) or (D,) words) when given."""
    acc = sobol_bits(idx, sv)
    if shift_bits is not None:
        acc = acc ^ shift_bits.to(torch.int64)
    return _to_unit(acc, 2.0 ** -_SOBOL_BITS)


def _shift_bits(u: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) -> digital-shift words below 2^30."""
    return (u * float(2.0 ** _SOBOL_BITS)).to(torch.int64) & _SOBOL_MASK


def _reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = (x >> 16) | ((x << 16) & MASK32)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    return x


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for uint32 words x, from 16-bit halves of x (each
    partial product stays below 2^48)."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & MASK32


def owen_scramble(x: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Hash-based Owen scrambling of MSB-aligned uint32 Sobol' digits
    (Laine-Karras permutation, Burley's hash)."""
    x = _reverse_bits32(x)
    x = (x + seed) & MASK32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ _mul32(x, c)
    return _reverse_bits32(x)


def sobol_path_uniforms(rkeys: torch.Tensor, pkeys: torch.Tensor, sample_idx: torch.Tensor,
                        max_depth: int, n_qmc_bounces: int, n_dims: int = 9) -> torch.Tensor:
    """(n_dims * max_depth, N) dim-major primary-sample coordinates for
    ``trace(uniforms=...)``: the first ``n_qmc_bounces`` bounces draw their
    NEE, BSDF, guide and roulette dimensions from Sobol' dimensions 2 on
    (the camera pair owns 0 and 1), Owen-scrambled with per-pixel seeds;
    deeper bounces keep the per-sample threefry stream ``trace`` draws
    itself."""
    nb = min(n_qmc_bounces, max_depth)
    d_qmc = n_dims * nb
    sv = sobol_direction_numbers(2 + d_qmc, device=sample_idx.device)[2:]
    seeds = rng_mod.event_bits(pkeys, rng_mod.TAG_QMC_SHIFT, d_qmc)  # (N, d_qmc)
    bits = owen_scramble(sobol_bits(sample_idx, sv) << 2, seeds)
    rows = [_to_unit(bits, 2.0 ** -32).T]
    for depth in range(nb, max_depth):
        rows.append(rng_mod.bounce_uniform(rkeys, depth, n_dims).T)
    return torch.cat(rows, dim=0)


def sobol_2d(sample_idx: torch.Tensor, pixel_uniform: torch.Tensor) -> torch.Tensor:
    """The first two Sobol' dimensions at ``sample_idx``, digitally shifted
    per pixel by ``pixel_uniform`` (N, 2): the camera jitter."""
    sv = sobol_direction_numbers(2, device=sample_idx.device)
    return sobol_point(sample_idx, sv, _shift_bits(pixel_uniform))
