"""Counter-based random numbers, bit-equal to the JAX reference.

Port of ``mitsuba_path_guiding_tpu/core/rng.py``: every draw is a
deterministic function of ``(seed, pixel_id, sample_index, depth, dim)``.
The JAX package runs ``jax.random`` with ``jax_threefry_partitionable=True``;
this module reproduces its bits exactly:

  * a key is a pair of uint32 words ``(k0, k1)``; ``base_key(seed)`` is
    ``(0, seed)`` (``threefry_seed``),
  * ``fold_in(key, data) = threefry2x32(key, (0, data))``,
  * ``uniform(key, (n,))`` hashes the counters ``(0, i)`` for i < n, XORs the
    two output words and keeps 23 mantissa bits (``_uniform``); a shape of
    more axes counts over the flattened shape (``uniform_shape``),
  * ``split(key, n)[i]`` is ``fold_in(key, i)`` (``_threefry_split_foldlike``),
  * ``choice`` with probabilities and ``permutation`` follow
    ``jax.random.choice`` and ``jax.random._shuffle``, with XLA's CPU order
    of float32 additions in the cumulative sum (``cumsum_xla``).

Keys are int64 tensors of shape (..., 2) holding uint32 values: PyTorch on
the CPU has no uint32 shifts, so the arithmetic runs in int64 and is masked
to 32 bits after every add and shift, identically on both devices.  No
global torch RNG is used anywhere in the port.
"""
from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)

# Distinct fold-in tags so camera / bounce / NEE streams never collide
# (same values as the reference).
TAG_CAMERA = 1 << 20
TAG_WAVELENGTH = (1 << 20) + 1
TAG_QMC_SHIFT = (1 << 20) + 2
TAG_BOUNCE0 = 0


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1, rounds: int = 20):
    """Threefry-2x32 of counter (x0, x1) under key (k0, k1).

    All arguments broadcast; int64 tensors (or ints) holding uint32 values.
    20 rounds is jax.random's hash; the fused kernel draws with 13."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & MASK32
    x1 = (x1 + k1) & MASK32
    for d in range((rounds + 3) // 4):
        for i in range(min(4, rounds - 4 * d)):
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, _ROT[(d % 2) * 4 + i]) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & MASK32
    return x0, x1


def bits_to_unit(bits):
    """uint32 bits (int64 tensor) -> float32 in [0, 1): 23 random mantissa
    bits under exponent 0, minus one (jax.random._uniform)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def base_key(seed: int, device=None) -> torch.Tensor:
    """(2,) key of ``jax.random.PRNGKey(seed)``: (0, seed), made on the
    device (a copy from the host would be a host sync on the card)."""
    return torch.arange(2, dtype=torch.int64, device=device) * (int(seed) & MASK32)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """keys (..., 2), data int tensor broadcastable to keys[..., 0] or an
    int -> folded keys (..., 2).  An int enters the hash as a scalar: no
    copy of it to the keys' device (a host sync on the card)."""
    k0, k1 = keys[..., 0], keys[..., 1]
    if torch.is_tensor(data):
        data = data.to(torch.int64) & MASK32
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    else:
        y0, y1 = threefry2x32(k0, k1, 0, int(data) & MASK32)
    y0, y1 = torch.broadcast_tensors(y0, y1)
    return torch.stack([y0, y1], dim=-1)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) uint32 bits of ``jax.random.bits(key, (n,))`` per key."""
    k0 = keys[..., 0:1]
    k1 = keys[..., 1:2]
    ctr = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(k0, k1, torch.zeros_like(ctr), ctr)
    return b0 ^ b1


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) float32 uniforms of ``jax.random.uniform(key, (n,))``."""
    return torch.clamp_min(bits_to_unit(random_bits(keys, n)), 0.0)


def pixel_keys(key: torch.Tensor, pixel_id: torch.Tensor) -> torch.Tensor:
    """Per-pixel keys (no sample index folded in)."""
    return fold_in(key.expand(pixel_id.shape + (2,)), pixel_id)


def ray_keys(key: torch.Tensor, pixel_id: torch.Tensor,
             sample_idx: torch.Tensor) -> torch.Tensor:
    """Per-ray keys from logical (pixel, sample) indices."""
    return fold_in(pixel_keys(key, pixel_id), sample_idx)


def bounce_uniform(rkeys: torch.Tensor, depth, n_dims: int) -> torch.Tensor:
    """(N, n_dims) uniforms for one wavefront bounce."""
    return uniform(fold_in(rkeys, depth), n_dims)


def event_uniform(rkeys: torch.Tensor, tag: int, n_dims: int) -> torch.Tensor:
    """(N, n_dims) uniforms for a named one-off event (e.g. camera)."""
    return bounce_uniform(rkeys, tag, n_dims)


def event_bits(rkeys: torch.Tensor, tag: int, n_dims: int) -> torch.Tensor:
    """(N, n_dims) uint32 bits (int64 tensor) for a named event."""
    return random_bits(fold_in(rkeys, tag), n_dims)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """(n, 2) keys of ``jax.random.split(key, n)``."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    return fold_in(key.expand(n, 2), idx)


def uniform_shape(key: torch.Tensor, shape) -> torch.Tensor:
    """float32 uniforms of ``jax.random.uniform(key, shape)`` for one key:
    the counters run over the flattened shape."""
    n = 1
    for s in shape:
        n *= int(s)
    return uniform(key[None], n)[0].reshape(tuple(shape))


def sum_xla(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of a 1-D tensor in XLA's CPU order: windows of 32
    (the array centred in its zero padding) each added from the left,
    repeated until 32 values remain, which add from the left."""
    while x.shape[0] > 32:
        n = x.shape[0]
        pad = (-n) % 32
        xp = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2)).reshape(-1, 32)
        x = _left_sum_rows(xp)
    return _left_sum_rows(x[None])[0]


def _left_sum_rows(x: torch.Tensor) -> torch.Tensor:
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


def cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """The float32 cumulative sum of a 1-D tensor in XLA's CPU order (its
    reduce-window rewrite): blocks of 16 summed from the left, each block
    then offset by the exclusive prefix of the block totals, that prefix
    computed the same way.  torch.cumsum adds in another order on each
    device."""
    n = x.shape[0]
    if n <= 16:
        return _left_cumsum_rows(x[None])[0]
    pad = (-n) % 16
    inner = _left_cumsum_rows(torch.nn.functional.pad(x, (0, pad)).reshape(-1, 16))
    totals = cumsum_xla(inner[:, -1].contiguous())
    excl = torch.cat([torch.zeros_like(totals[:1]), totals[:-1]])
    return (inner + excl[:, None]).reshape(-1)[:n]


def _left_cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    cols = [x[:, 0]]
    for k in range(1, x.shape[1]):
        cols.append(cols[-1] + x[:, k])
    return torch.stack(cols, dim=1)


def choice(key: torch.Tensor, n: int, shape, p: torch.Tensor) -> torch.Tensor:
    """int64 draws of ``jax.random.choice(key, n, shape, p=p)`` (with
    replacement): the cumulative sum of p, r = total (1 - u), and the
    first index whose cumulative sum reaches r."""
    if p.shape != (n,):
        raise ValueError(f"p must have shape ({n},), got {tuple(p.shape)}")
    cdf = cumsum_xla(p.to(torch.float32))
    r = cdf[-1] * (1.0 - uniform_shape(key, shape))
    return torch.searchsorted(cdf, r.reshape(-1)).reshape(tuple(shape))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """int64 permutation of ``jax.random.permutation(key, n)``: rounds of a
    stable sort of the values by fresh 32-bit keys, ceil(3 ln n / ln
    (2^32 - 1)) of them, each round's bits from the second key of a split
    whose first key carries on."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
    for _ in range(rounds):
        key, sub = split(key, 2)
        order = torch.sort(random_bits(sub[None], n)[0], stable=True).indices
        x = x[order]
    return x
