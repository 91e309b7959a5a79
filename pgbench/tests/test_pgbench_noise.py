"""The end-to-end arithmetic on synthetic images and latencies."""
import numpy as np
import pytest
import torch

from pgbench.harness import noise


def test_relvar_of_known_noise():
    # halves of a flat image with Gaussian noise of relative std s each: the
    # full image's relative variance is s^2 / 2, with the regulariser's
    # (0.1)^2 share in the denominator
    g = torch.Generator().manual_seed(0)
    base = torch.full((200000, 3), 2.0, dtype=torch.float64)
    s = 0.05
    a = base * (1 + s * torch.randn(base.shape, generator=g, dtype=torch.float64))
    b = base * (1 + s * torch.randn(base.shape, generator=g, dtype=torch.float64))
    v = noise.relvar_from_halves(a, b)
    assert v == pytest.approx(s * s / 2 / 1.01, rel=0.03)


def test_relvar_trims_the_worst_pixels():
    a = torch.ones((10000, 3), dtype=torch.float64)
    b = a.clone()
    b[:5] = 1e6          # 0.05% fireflies: trimmed
    assert noise.relvar_from_halves(a, b) == 0.0
    b[:20] = 1e6         # 0.2%: not all trimmed
    assert noise.relvar_from_halves(a, b) > 0.0


def test_time_to_noise_scales_with_time_and_variance():
    assert noise.time_to_noise(10.0, 0.04) == pytest.approx(40.0)
    assert noise.time_to_noise(5.0, 0.01) == pytest.approx(5.0)


def test_percentile():
    lat = list(np.arange(1, 101, dtype=np.float64))
    assert noise.percentile(lat, 50) == pytest.approx(50.5)
    assert noise.percentile(lat, 95) == pytest.approx(95.05)
