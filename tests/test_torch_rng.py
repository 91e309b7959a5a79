"""The port's threefry random numbers are bit-equal to jax.random with
jax_threefry_partitionable=True (core/rng.py of both packages)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.integrators.render import wave_keys_and_jitter as j_wave
from mitsuba_path_guiding_torch.core import rng as trng
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, wave_keys_and_jitter
import torch_port_parity  # noqa: F401  (shares the cores among xdist workers)

N = 100_000


def _lanes(seed=0):
    rs = np.random.default_rng(seed)
    pix = rs.integers(0, 2**31 - 1, N).astype(np.int32)
    sidx = rs.integers(0, 1 << 16, N).astype(np.int32)
    return pix, sidx


def _keys(seed):
    pix, sidx = _lanes(seed)
    kj = jrng.ray_keys(jrng.base_key(seed), jnp.asarray(pix), jnp.asarray(sidx))
    kt = trng.ray_keys(trng.base_key(seed), torch.from_numpy(pix), torch.from_numpy(sidx))
    return kj, kt


@pytest.mark.parametrize("seed", [0, 7, 123456])
def test_base_key_and_fold_in(seed):
    np.testing.assert_array_equal(np.asarray(jrng.base_key(seed)), trng.base_key(seed).numpy())
    pix, _ = _lanes(seed)
    kj = jrng.pixel_keys(jrng.base_key(seed), jnp.asarray(pix))
    kt = trng.pixel_keys(trng.base_key(seed), torch.from_numpy(pix))
    np.testing.assert_array_equal(np.asarray(kj).astype(np.int64), kt.numpy())


def test_ray_keys_bit_equal():
    kj, kt = _keys(3)
    np.testing.assert_array_equal(np.asarray(kj).astype(np.int64), kt.numpy())


@pytest.mark.parametrize("depth", [0, 4])
def test_bounce_uniform_bit_equal(depth):
    kj, kt = _keys(11)
    uj = np.asarray(jrng.bounce_uniform(kj, depth, 9))
    ut = trng.bounce_uniform(kt, depth, 9).numpy()
    assert ut.dtype == np.float32
    np.testing.assert_array_equal(uj, ut)


def test_event_uniform_bit_equal():
    kj, kt = _keys(5)
    np.testing.assert_array_equal(
        np.asarray(jrng.event_uniform(kj, jrng.TAG_CAMERA, 4)),
        trng.event_uniform(kt, trng.TAG_CAMERA, 4).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng.event_bits(kj, jrng.TAG_QMC_SHIFT, 2)).astype(np.int64),
        trng.event_bits(kt, trng.TAG_QMC_SHIFT, 2).numpy())


def test_wave_keys_and_jitter_bit_equal():
    pix = np.arange(4096, dtype=np.int32)
    sidx = np.full(4096, 9, np.int32)
    outs_j = j_wave(JRenderConfig(seed=4), jnp.asarray(pix), jnp.asarray(sidx))
    outs_t = wave_keys_and_jitter(RenderConfig(seed=4), torch.from_numpy(pix).long(),
                                  torch.from_numpy(sidx).long())
    for a, b in zip(outs_j, outs_t):
        a = np.asarray(a)
        np.testing.assert_array_equal(a.astype(np.int64) if a.dtype == np.uint32 else a, b.numpy())


def test_threefry13_matches_reference_kernel_hash():
    """13-round threefry of the fused kernel: port vs the reference's
    implementation (mitsuba_path_guiding_tpu/ops/fused_path.py)."""
    from mitsuba_path_guiding_tpu.ops.fused_path import threefry2x32 as j_tf

    rs = np.random.default_rng(2)
    k0, k1, x0, x1 = (rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
                      for _ in range(4))
    for rounds in (13, 20):
        yj = j_tf(*(jnp.asarray(a) for a in (k0, k1, x0, x1)), rounds=rounds)
        yt = trng.threefry2x32(*(torch.from_numpy(a.astype(np.int64)) for a in (k0, k1, x0, x1)),
                               rounds=rounds)
        for a, b in zip(yj, yt):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy())
