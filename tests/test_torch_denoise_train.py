"""The port's denoiser training (film/neural_denoise.py init_params,
apply_net, save_params; film/train_denoiser.py; film/denoise_gate.py)
against the JAX package and tools/train_denoiser.py on the CPU, at small
sizes: parameter counts, layouts and initial statistics; apply_net on
JAX-initialised weights with a random head (rtol 1e-4, atol 1e-5); the
loss and its gradient against jax.value_and_grad of the tool's loss (loss
rtol 1e-5, each gradient within 1e-4 of its largest magnitude); the
schedule against optax's (1e-7) and Adam against optax.adam (1e-6); the
flip against numpy; the tool's scene draws and feature buffers; weights
written by the port read by JAX's load_params; repeatable training."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mitsuba_path_guiding_torch.film import denoise_gate as tdg
from mitsuba_path_guiding_torch.film import neural_denoise as tnn
from mitsuba_path_guiding_torch.film import train_denoiser as ttd
from mitsuba_path_guiding_tpu.film import neural_denoise as jnn
from torch_port_parity import assert_tree_equal

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jtool():
    """tools/train_denoiser.py loaded by path (its work runs only as a
    script)."""
    spec = importlib.util.spec_from_file_location("jax_train_denoiser",
                                                  ROOT / "tools" / "train_denoiser.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jparams():
    """JAX-initialised weights with a random head, as numpy (so every
    layer carries gradient)."""
    p = {k: np.asarray(v) for k, v in jnn.init_params(jax.random.key(3)).items()}
    rs = np.random.default_rng(8)
    p["out_w"] = (0.05 * rs.standard_normal(p["out_w"].shape)).astype(np.float32)
    p["out_b"] = (0.01 * rs.standard_normal(p["out_b"].shape)).astype(np.float32)
    return p


def _torch_params(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _dataset(n=3, res=24, seed=0):
    """A synthetic dataset of ``n`` images: x (n, res, res, 10) noisy
    colour with fireflies, albedo, unit normals, depth; y the clean
    colour."""
    rs = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, res), np.linspace(0, 1, res), indexing="ij")
    xs, ys = [], []
    for i in range(n):
        base = np.stack([0.3 + 0.5 * xx, 0.2 + 0.4 * yy, 0.4 + 0.2 * xx * yy], -1) * (1 + 0.3 * i)
        noisy = base * rs.gamma(2.0, 0.5, (res, res, 1))
        noisy[rs.random((res, res)) < 0.01] = 30.0
        albedo = np.clip(base / (1 + 0.3 * i) + 0.05 * rs.standard_normal((res, res, 3)), 0, 1)
        normal = np.stack([0.2 * xx - 0.1, np.where(yy > 0.5, 0.9, 0.1), np.ones_like(xx)], -1)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        depth = np.where(xx > 0.6, 2.0, 5.0 + yy)[..., None]
        xs.append(np.concatenate([noisy, albedo, normal, depth], -1))
        ys.append(base)
    return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)


def test_init_params_match_the_reference():
    got = tnn.init_params(torch.Generator().manual_seed(0))
    want = jnn.init_params(jax.random.key(0))
    assert tnn.n_params(got) == jnn.n_params(want) == 229123
    assert list(got) == list(want)
    for name, k, cin, cout, _ in tnn._conv_spec():
        w, b = got[name + "_w"], got[name + "_b"]
        assert tuple(w.shape) == tuple(want[name + "_w"].shape) == (k, k, cin, cout)
        assert w.dtype == b.dtype == torch.float32
        assert not b.any()
        if name == "out":
            assert not w.any()
        else:
            he = np.sqrt(2.0 / (k * k * cin))
            assert abs(float(w.std()) / he - 1.0) < 0.1, name


def test_apply_net_matches_the_reference(jparams):
    x = np.random.default_rng(4).standard_normal((2, 16, 20, tnn.IN_CH)).astype(np.float32)
    want = np.asarray(jnn.apply_net({k: jnp.asarray(v) for k, v in jparams.items()},
                                    jnp.asarray(x)))
    got = tnn.apply_net(_torch_params(jparams), torch.from_numpy(x))
    assert got.shape == want.shape == (2, 16, 20, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the module holds the same weights (OIHW) and gives the same residual
    net = tnn.DenoiserNet(jparams)
    assert all(p.requires_grad for p in net.parameters())
    by_net = ttd.net_residual(net)(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(by_net.numpy(), got.numpy(), rtol=1e-5, atol=1e-6)
    assert all(torch.equal(net.params()[k], v) for k, v in _torch_params(jparams).items())


def _reference_loss(params, xb, yb):
    """tools/train_denoiser.py:182-199 (prep and loss_fn) from the JAX
    package's apply_net and pack_inputs."""
    def prep(x_img, y_img):
        xin, demob, alb = jnn.pack_inputs(x_img[..., 0:3], x_img[..., 10:13], x_img[..., 3:6],
                                          x_img[..., 6:9], x_img[..., 9])
        return xin, demob, jnp.log1p(jnp.maximum(y_img, 0.0) / alb)

    xin, demod, y_log = jax.vmap(prep)(xb, yb)
    out_log = jnp.maximum(demod + jnn.apply_net(params, xin), 0.0)
    l1 = jnp.mean(jnp.abs(out_log - y_log))
    gx = jnp.mean(jnp.abs(jnp.diff(out_log, axis=2) - jnp.diff(y_log, axis=2)))
    gy = jnp.mean(jnp.abs(jnp.diff(out_log, axis=1) - jnp.diff(y_log, axis=1)))
    return l1 + 0.5 * (gx + gy)


@pytest.fixture(scope="module")
def batch():
    """Two 16x16 crops of the synthetic dataset with their a-trous bases
    (channels 10:13), one of them flipped."""
    x, y = _dataset()
    X = ttd.with_bases(x, "cpu")
    Y = torch.from_numpy(y)
    return ttd.draw_batch(X, Y, torch.Generator().manual_seed(5), 2, 16)


def test_loss_and_gradient_match_the_reference(jparams, batch):
    xb, yb = batch
    jp = {k: jnp.asarray(v) for k, v in jparams.items()}
    loss_j, grad_j = jax.value_and_grad(_reference_loss)(jp, jnp.asarray(xb.numpy()),
                                                         jnp.asarray(yb.numpy()))
    net = tnn.DenoiserNet(jparams)
    loss = ttd.loss_fn(ttd.net_residual(net), xb, yb)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for name, *_ in tnn._conv_spec():
        for s, g in (("_w", getattr(net, name + "_w").grad.permute(2, 3, 1, 0)),
                     ("_b", getattr(net, name + "_b").grad)):
            want = np.asarray(grad_j[name + s])
            scale = np.abs(want).max()
            assert scale > 0, name + s
            assert np.abs(g.numpy() - want).max() <= 1e-4 * scale, name + s
    # the functional form gives the module's loss
    assert torch.equal(ttd.loss_fn(lambda x: tnn.apply_net(_torch_params(jparams), x), xb, yb),
                       loss.detach())


def test_zero_head_loss_is_the_zero_residual_loss(batch):
    xb, yb = batch
    net = tnn.DenoiserNet(tnn.init_params(torch.Generator().manual_seed(1)))
    assert torch.equal(ttd.loss_fn(ttd.net_residual(net), xb, yb).detach(),
                       ttd.zero_residual_loss(xb, yb))


def test_schedule_matches_optax():
    steps, lr = 200, 2e-3
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=max(steps // 20, 50),
                                               decay_steps=steps)
    got = np.array([ttd.lr_at(i, lr, steps) for i in range(steps)])
    want = np.array([float(sched(i)) for i in range(steps)])
    assert got[0] == 0.0 and got.max() == pytest.approx(lr)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("lr", ["schedule", "constant"])
def test_adam_matches_optax(lr):
    """Five steps on fixed gradients: the 200-step schedule's first five
    counts, and a constant 1e-2 (where the updates are large enough to
    show a wrong bias correction)."""
    steps = 200
    sched = (optax.warmup_cosine_decay_schedule(0.0, 2e-3, 50, steps) if lr == "schedule"
             else optax.constant_schedule(1e-2))
    lr_of = (lambda i: ttd.lr_at(i, 2e-3, steps)) if lr == "schedule" else (lambda i: 1e-2)
    rs = np.random.default_rng(2)
    params = {"a": rs.standard_normal((3, 4)).astype(np.float32),
              "b": rs.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rs.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    opt = optax.adam(sched)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    adam = ttd.Adam(tp)
    for i, g in enumerate(grads):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state)
        jp = optax.apply_updates(jp, upd)
        adam.step([torch.from_numpy(g[k]) for k in ("a", "b")], lr_of(i))
    for k, p in zip(("a", "b"), tp):
        np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        if lr == "constant":
            assert np.abs(p.numpy() - params[k]).min() > 1e-3


def test_flip_matches_numpy():
    rs = np.random.default_rng(6)
    xb = rs.standard_normal((3, 4, 5, 13)).astype(np.float32)
    yb = rs.standard_normal((3, 4, 5, 3)).astype(np.float32)
    flip = np.array([True, False, True])
    xf, yf = xb[:, :, ::-1, :].copy(), yb[:, :, ::-1, :].copy()
    xf[..., 6] *= -1.0
    want_x = np.where(flip[:, None, None, None], xf, xb)
    want_y = np.where(flip[:, None, None, None], yf, yb)
    got_x, got_y = ttd.flip_batch(torch.from_numpy(xb), torch.from_numpy(yb),
                                  torch.from_numpy(flip))
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_y.numpy(), want_y)


def test_draw_batch_crops_in_range():
    x, y = _dataset(n=2, res=12)
    X, Y = torch.from_numpy(np.concatenate([x, x[..., :3]], -1)), torch.from_numpy(y)
    xb, yb = ttd.draw_batch(X, Y, torch.Generator().manual_seed(0), 64, 4)
    assert xb.shape == (64, 4, 4, 13) and yb.shape == (64, 4, 4, 3)
    # each crop is a window of one image, mirrored or not
    for i in range(64):
        found = False
        for n in range(2):
            for oy in range(8):
                for ox in range(8):
                    win = Y[n, oy:oy + 4, ox:ox + 4]
                    found |= torch.equal(yb[i], win) or torch.equal(yb[i], win.flip(1))
        assert found, i


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_rand_cornell_matches_the_tool(jtool, seed):
    got = ttd.rand_cornell(np.random.default_rng(seed))
    want = jtool.rand_cornell(np.random.default_rng(seed))
    assert_tree_equal(got, want)


@pytest.mark.parametrize("gen", ["gen1", "gen2"])
def test_recipe_scenes_match_the_tool(jtool, gen, tmp_path, monkeypatch):
    """The tool's gen_dataset with its renders stubbed (the scenes it
    builds are recorded) against recipe_descs."""
    n, seed, _ = ttd.GENERATIONS[gen]
    seen = []
    monkeypatch.setattr(jtool, "build_scene", lambda d: seen.append(d))
    monkeypatch.setattr(jtool, "render_scanned", lambda s, c: np.zeros((1, 1, 3), np.float32))
    monkeypatch.setattr(jtool, "render_aov_buffers", lambda s, w, h, k: (
        np.zeros((1, 1, 3)), np.zeros((1, 1, 3)), np.zeros((1, 1))))
    jtool.gen_dataset(n_scenes=n, out=str(tmp_path / "d.npz"), seed=seed)
    got = ttd.recipe_descs(n, seed)
    assert len(got) == len(seen) == 16
    for a, b in zip(got, seen):
        assert_tree_equal(a, b)


def test_render_aov_buffers_match_the_tool(jtool):
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene

    desc = ttd.rand_cornell(np.random.default_rng(3))
    got = ttd.render_aov_buffers(build_scene(desc, device="cpu"), 16, 16, 7)
    want = jtool.render_aov_buffers(j_build_scene(jtool.rand_cornell(np.random.default_rng(3))),
                                    16, 16, 7)
    for a, b in zip(got, want):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-5)
    assert float(got[2].mean()) > 1.0


def _image(h, w, seed=1):
    color, albedo, normal, depth = (a[0] for a in np.split(_dataset(1, max(h, w), seed)[0]
                                                           [:, :h, :w], [3, 6, 9], axis=-1))
    return color, albedo, normal, depth[..., 0]


def test_saved_weights_load_in_the_reference(jparams, tmp_path):
    """save_params on JAX-initialised weights with a random head, and on
    the weights of three CPU steps: the reference's load_params reads
    them, and its denoise_neural_params gives the port's on a 32x32 image
    (rtol 1e-4, atol 1e-6)."""
    x, y = _dataset()
    net, rec = ttd.train((x, y), steps=3, batch=2, crop=16, device="cpu",
                         out=str(tmp_path / "trained.npz"), log=lambda s: None)
    tnn.save_params(_torch_params(jparams), str(tmp_path / "random_head.npz"))
    with np.load(tnn._WEIGHTS_FILE) as ref:
        layout = {k: (ref[k].shape, ref[k].dtype) for k in ref.files}
    bufs = _image(32, 32)
    for name, params in (("trained", net.params()), ("random_head", _torch_params(jparams))):
        path = str(tmp_path / f"{name}.npz")
        with np.load(path) as z:
            assert {k: (z[k].shape, z[k].dtype) for k in z.files} == layout
            for k, v in params.items():
                np.testing.assert_array_equal(z[k], v.numpy().astype(np.float16))
        jp = jnn.load_params(path)
        want = np.asarray(jnn.denoise_neural_params(jp, *(jnp.asarray(a) for a in bufs)))
        got = tnn.denoise_neural_params(_torch_params(tnn.load_params(path)),
                                        *(torch.from_numpy(a) for a in bufs))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
        assert torch.equal(tnn.load_net("cpu", path).params()["out_w"],
                           params["out_w"].half().float())


def test_training_repeats_bit_for_bit():
    x, y = _dataset()
    runs = [ttd.train((x, y), steps=3, batch=2, crop=16, seed=4, device="cpu",
                      log=lambda s: None) for _ in range(2)]
    (net_a, rec_a), (net_b, rec_b) = runs
    assert rec_a["loss0"] == rec_a["loss0_zero_residual"]
    assert rec_a["losses"] == rec_b["losses"]
    assert all(torch.equal(a, b) for a, b in zip(net_a.parameters(), net_b.parameters()))
    start = tnn.DenoiserNet(tnn.init_params(torch.Generator().manual_seed(4)))
    assert not torch.equal(net_a.out_w, start.out_w)


def test_cli_trains_on_the_cpu(tmp_path, monkeypatch):
    """``python -m ...train_denoiser 2 --device cpu`` with DN_DATA, DN_OUT
    and DN_SEED: trains from an existing dataset and writes the weights
    where DN_OUT says."""
    data = tmp_path / "denoise_data_torch.npz"
    np.savez_compressed(data, **dict(zip(("x", "y"), _dataset(n=2, res=72))))
    monkeypatch.setattr(ttd, "data_path", lambda suffix="": str(tmp_path /
                                                                 f"denoise_data_torch{suffix}.npz"))
    monkeypatch.setenv("DN_OUT", str(tmp_path / "w" / "weights.npz"))
    monkeypatch.setenv("DN_SEED", "2")
    monkeypatch.delenv("DN_DATA", raising=False)
    assert ttd.main(["2", "--device", "cpu"]) == 0
    assert len(tnn.load_params(str(tmp_path / "w" / "weights.npz"))) == 22


def test_gates_and_sweep(tmp_path, monkeypatch):
    """The Cornell gate at 16x16 on the CPU: the untrained net's MSE is
    the a-trous filter's (the zero head); a two-seed sweep of two steps
    writes the better seed's weights to its output."""
    monkeypatch.setattr(tdg, "GATE_RES", 16)
    monkeypatch.setattr(tdg, "GATES", ("cornell",))
    zero = tnn.init_params(torch.Generator().manual_seed(0))
    m_n, m_a, m_noisy = tdg.gate_metric(zero, "cornell", device="cpu")
    assert m_n == pytest.approx(m_a, rel=1e-4) and m_noisy > 0
    out = tmp_path / "best.npz"
    results = tdg.sweep([0, 1], data=_dataset(n=2, res=72), steps=2, device="cpu", out=str(out),
                        log=lambda s: None)
    assert [r["seed"] for r in sorted(results, key=lambda r: r["seed"])] == [0, 1]
    assert results[0]["score"] <= results[1]["score"]
    assert out.read_bytes() == pathlib.Path(results[0]["path"]).read_bytes()
