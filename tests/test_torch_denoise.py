"""The port's denoisers against the JAX package on the CPU, at 32x32 and at
30x34 (not a multiple of 4: the stride-2 "SAME" padding and the edge pad
of the net's input): the zero-padded shift, firefly suppression, the
a-trous filter, the HDR pipeline and the feature prefilter to rtol 1e-5,
the neural denoiser to rtol 1e-4 (atol 1e-6), the net's layers on their
own; the feature buffers of a progressive renderer; the CLI's --denoise
and --aovs; the weights file a byte copy of the reference's."""
import hashlib
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.film import denoise as tden
from mitsuba_path_guiding_torch.film import neural_denoise as tnn
from mitsuba_path_guiding_tpu.film import denoise as jden
from mitsuba_path_guiding_tpu.film import neural_denoise as jnn

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZES = [(32, 32), (30, 34)]


def _buffers(h, w, seed=0):
    """A noisy HDR image with fireflies, an albedo, unit normals and a
    depth buffer with a discontinuity."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    base = np.stack([0.3 + 0.5 * xx, 0.2 + 0.4 * yy, 0.4 + 0.2 * xx * yy], -1)
    color = (base * rng.gamma(2.0, 0.5, (h, w, 1))).astype(np.float32)
    color[rng.random((h, w)) < 0.01] = 40.0
    albedo = np.clip(base + 0.05 * rng.standard_normal((h, w, 3)), 0.0, 1.0).astype(np.float32)
    normal = np.stack([0.2 * xx - 0.1, np.where(yy > 0.5, 0.9, 0.1), np.ones_like(xx)], -1)
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    depth = np.where(xx > 0.6, 2.0, 5.0 + yy).astype(np.float32)
    return color, albedo, normal, depth


@pytest.fixture(scope="module", params=SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def bufs(request):
    return _buffers(*request.param)


def _both(fn_t, fn_j, arrays, **kw):
    got = fn_t(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


def test_shift2d_is_zero_padded(bufs):
    color = bufs[0]
    for dy, dx in ((1, 0), (-2, 3), (0, -4), (5, 5)):
        got, valid = tden._shift2d(torch.from_numpy(color), dy, dx)
        want, jvalid = jden._shift2d(jnp.asarray(color), dy, dx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        # a roll would wrap the far border in; the shift zeroes it
        assert not valid.bool().all()


def test_firefly_suppress_matches_reference(bufs):
    got, want = _both(tden.firefly_suppress, jden.firefly_suppress, bufs[:1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert float(got.max()) < 40.0


@pytest.mark.parametrize("iterations,sigma_color", [(4, 0.45)])
def test_atrous_matches_reference(bufs, iterations, sigma_color):
    got, want = _both(tden.atrous_denoise, jden.atrous_denoise, bufs, iterations=iterations,
                      sigma_color=sigma_color)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_denoise_hdr_matches_reference(bufs):
    got, want = _both(tden.denoise_hdr, jden.denoise_hdr, bufs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_prefilter_features_matches_reference(bufs):
    _, albedo, normal, depth = bufs
    (a_t, n_t), (a_j, n_j) = _both(tden.prefilter_features, jden.prefilter_features,
                                   (albedo, normal, depth))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-5, atol=1e-6)


def test_net_layers_match_reference():
    """The U-Net alone on a 1 x 16 x 20 x 13 input: HWIO -> OIHW, the
    stride-2 SAME padding (0 before, 1 after) and the upsampling."""
    params = jnn.load_params()
    net = tnn.load_net("cpu")
    x = np.random.default_rng(4).standard_normal((1, 16, 20, tnn.IN_CH)).astype(np.float32)
    want = np.asarray(jnn.apply_net(params, jnp.asarray(x)))
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert [n for n, *_ in tnn._conv_spec()] == [n for n, *_ in jnn._conv_spec()]
    assert tnn._same_pad(16, 3, 2) == (0, 1) and tnn._same_pad(15, 3, 2) == (1, 1)


def test_neural_denoiser_matches_reference(bufs):
    got, want = _both(tnn.denoise_neural, jnn.denoise_neural, bufs)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    # the net moved the a-trous base
    base = tden.denoise_hdr(*(torch.from_numpy(a) for a in bufs))
    assert not torch.equal(got, base)


def test_missing_weights_fall_back_to_atrous(tmp_path):
    assert tnn.load_params(str(tmp_path / "none.npz")) is None
    assert tnn.load_net("cpu", str(tmp_path / "none.npz")) is None


def test_weights_are_a_byte_copy_of_the_reference():
    def sha(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()

    name = "denoiser_weights.npz"
    assert sha(ROOT / "mitsuba_path_guiding_torch" / "data" / name) == sha(
        ROOT / "mitsuba_path_guiding_tpu" / "data" / name)
    params = tnn.load_params()
    assert all(v.dtype == np.float32 for v in params.values()) and len(params) == 22


def test_render_aovs_match_reference():
    """The averaged feature buffers of a fresh progressive renderer on the
    Cornell box at 12x12 (4 waves, no records) against the JAX package's."""
    from mitsuba_path_guiding_torch.integrators.progressive import (
        ProgressiveConfig,
        ProgressiveRenderer,
    )
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.scene import scenes as tscenes
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_tpu.integrators import progressive as jprog
    from mitsuba_path_guiding_tpu.integrators import render as jrender
    from mitsuba_path_guiding_tpu.scene import scenes as jscenes
    from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene

    kw = dict(samples_per_progression=2, n_progressions=1, guiding=True, grid_res=4, n_lobes=8)
    jr = jprog.ProgressiveRenderer(j_build_scene(jscenes.cornell_box()), jprog.ProgressiveConfig(
        render=jrender.RenderConfig(width=12, height=12, spp=0, max_depth=3), **kw))
    pr = ProgressiveRenderer(build_scene(tscenes.cornell_box(), device="cpu"), ProgressiveConfig(
        render=RenderConfig(width=12, height=12, spp=0, max_depth=3), **kw))
    got, want = tden.render_aovs(pr), jden.render_aovs(jr)
    grid_before = pr.grid.valid.clone()
    for k in ("albedo", "normal", "depth"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert torch.equal(pr.grid.valid, grid_before) and pr.sample_counter == 0


def test_cli_denoise_and_aovs(tmp_path):
    """The CLI's cornell at 16x16, 4 spp with --denoise --aovs on the CPU:
    the denoised image and the three AOV files."""
    from mitsuba_path_guiding_torch.render import main

    out = tmp_path / "c.npy"
    assert main(["cornell", "-o", str(out), "-r", "16x16", "-s", "4", "--device", "cpu",
                 "--denoise", "--aovs"]) == 0
    img = np.load(out)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all() and img.mean() > 0.0
    shapes = {k: np.load(tmp_path / f"c_{k}.npy").shape for k in ("albedo", "normal", "depth")}
    assert shapes == {"albedo": (16, 16, 3), "normal": (16, 16, 3), "depth": (16, 16, 1)}
