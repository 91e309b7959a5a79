"""The port's Markov-chain integrators against the JAX package on the CPU:
``core/rng.py``'s ``split``, 2-D ``uniform``, ``choice`` and
``permutation`` (and the XLA-order sums under ``choice``) bit-equal to
``jax.random``; PSSMLT's ``_mutate_small``, ``_path_eval``, one chain step
and its bootstrap's seed indices; one ERPT ``_redistribute``; MLT's
``_trace_path``, ``_eval_chain``, ``_perturb`` and one large and one
perturbation step from the same state (carried across by ``convert.py``);
``render_pssmlt``, ``render_erpt`` and ``render_mlt`` at 16x16; the CLI's
``-I pssmlt|mlt|erpt``.  Slow twins of the JAX package's MLT, PSSMLT and
ERPT tests (tests/test_mlt.py, tests/test_ptracer.py,
tests/test_vpl_erpt.py) hold the port to its own path tracer with their
bars, slow as theirs are.

Tolerances: the random numbers bit-equal; per-lane values rtol 1e-4 /
atol 1e-6 and flags equal, each on >= 99% of lanes (XLA on the CPU
contracts multiply-adds, and one ulp can flip an acceptance); images'
means within 1e-3 relative and >= 99% of pixels within 1e-3.  The JAX
references are shared through module-scoped fixtures."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch import render as cli
from mitsuba_path_guiding_torch.convert import mlt_state_from_numpy, tensors_from_numpy
from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.spectrum import luminance
from mitsuba_path_guiding_torch.integrators import erpt, mlt, pssmlt
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box
from mitsuba_path_guiding_tpu.core import rng as jrng  # noqa: F401  (threefry partitionable)
from mitsuba_path_guiding_tpu.core.spectrum import luminance as jluminance
from mitsuba_path_guiding_tpu.integrators import erpt as jerpt
from mitsuba_path_guiding_tpu.integrators import mlt as jmlt
from mitsuba_path_guiding_tpu.integrators import pssmlt as jpssmlt
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.models.bsdf import types_present as jtypes_present
from mitsuba_path_guiding_tpu.models.emitter import kinds_present as jkinds_present
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, port_scene, t, to_numpy_tree

W = H = 16
LANE_RTOL = 1e-4
MIN_LANES = 0.99
IMG_RTOL = 1e-3


def chain_descs(mod):
    """chip_smoke.py's chain scenes (tests/test_mlt.py's big-light and
    mirror-slab boxes among them) from a scenes module, the port's or the
    JAX package's."""
    from chip_smoke import chain_descs as descs

    return descs(mod)


def _img_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert got.mean() == pytest.approx(float(want.mean()), rel=IMG_RTOL)
    assert frac_close(got, want, rtol=IMG_RTOL, atol=1e-5) >= MIN_LANES


# ---- core/rng.py

@pytest.mark.parametrize("n", [1, 1000, 131072])
def test_permutation_bit_equal(n):
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(17), n))
    np.testing.assert_array_equal(rng.permutation(rng.base_key(17), n).numpy(), want)


@pytest.mark.parametrize("n", [2, 3, 1000])
def test_split_bit_equal(n):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(5), n)).astype(np.int64)
    np.testing.assert_array_equal(rng.split(rng.base_key(5), n).numpy(), want)


@pytest.mark.parametrize("shape", [(22, 1000), (49, 4096), (3, 5, 7)])
def test_uniform_shape_bit_equal(shape):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), shape))
    np.testing.assert_array_equal(rng.uniform_shape(rng.base_key(3), shape).numpy(), want)


@pytest.mark.parametrize("n", [5, 16, 17, 257, 1000, 16384, 32768, 131072])
def test_sum_and_cumsum_in_xla_order(n):
    x = np.random.default_rng(n).random(n).astype(np.float32) ** 4
    np.testing.assert_array_equal(rng.cumsum_xla(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.cumsum(x)))
    assert rng.sum_xla(torch.from_numpy(x)).numpy() == np.asarray(jnp.sum(x))


@pytest.mark.parametrize("n_boot, n_chains", [(1000, 256), (32768, 8192)])
def test_choice_bit_equal(n_boot, n_chains):
    """Every seed index equal, on probabilities with many exact zeros."""
    w = np.random.default_rng(1).random(n_boot).astype(np.float32) ** 6
    w[::3] = 0.0
    p = np.asarray(w / jnp.maximum(jnp.sum(w), 1e-30))
    want = np.asarray(jax.random.choice(jax.random.PRNGKey(9), n_boot, shape=(n_chains,), p=p))
    got = rng.choice(rng.base_key(9), n_boot, (n_chains,), torch.from_numpy(p.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- PSSMLT and ERPT on the Cornell box

class _PSS:
    def __init__(self):
        self.jscene = j_build_scene(jscenes.cornell_box())
        self.scene = port_scene(self.jscene)
        self.jcfg = JRenderConfig(width=W, height=H, spp=4, max_depth=2, seed=0)
        self.cfg = RenderConfig(width=W, height=H, spp=4, max_depth=2, seed=0)
        self.jst = (jkinds_present(self.jscene.emitters), jtypes_present(self.jscene.mats),
                    False, True, int(self.jscene.sensor.kind))
        self.st = pssmlt.scene_statics(self.scene, self.cfg)
        self.dims = pssmlt.pss_dims(self.cfg)
        self.u = jax.random.uniform(jax.random.PRNGKey(1), (self.dims, 4096))
        self.jeval = jpssmlt._path_eval(self.jscene, self.jcfg, self.u, self.jst)


@pytest.fixture(scope="module")
def pss():
    return _PSS()


def test_mutate_small_lanes():
    bits = jax.random.uniform(jax.random.PRNGKey(2), (3, 31, 4096))
    want = np.asarray(jpssmlt._mutate_small(bits[0], (bits[1], bits[2])))
    got = pssmlt._mutate_small(t(bits[0]), (t(bits[1]), t(bits[2]))).numpy()
    # the distance on the circle [0, 1) (a coordinate an ulp from 1 may
    # wrap to 0 on one side only); each lane's 31 coordinates at once
    diff = np.abs(got - want)
    diff = np.minimum(diff, 1.0 - diff)
    assert (diff <= 1e-6).all(axis=0).mean() >= MIN_LANES
    assert ((got >= 0.0) & (got < 1.0)).all()


def test_path_eval_lanes(pss):
    c, xy = pssmlt._path_eval(pss.scene, pss.cfg, t(pss.u), pss.st)
    jc, jxy = (np.asarray(x) for x in pss.jeval)
    assert frac_close(c.numpy(), jc, rtol=LANE_RTOL) >= MIN_LANES
    assert frac_close(xy.numpy(), jxy, rtol=1e-5) >= MIN_LANES
    assert (jc.max(axis=-1) > 0).mean() > 0.05


def test_pssmlt_chain_step_lanes(pss):
    """One mutation of 1024 chains (the render test's count) from the same
    state: the splats, the next states and the acceptances."""
    n = 1024
    u = pss.u[:, :n]
    jc, jxy = (x[:n] for x in pss.jeval)
    ji = jnp.maximum(jluminance(jc), 1e-12)
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.PRNGKey(4),
                                                           jnp.arange(n))
    jacc = jnp.zeros((W * H, 3))
    ju, ji2, jc2, jxy2, jacc = jpssmlt._chain_steps(
        pss.jscene, pss.jcfg, pss.jst, u, ji, jc, jxy, keys, 0, jacc, 1, 0.3)
    chain = tensors_from_numpy([np.asarray(x) for x in (u, ji, jc, jxy)], device="cpu")
    acc = torch.zeros((W * H, 3))
    u2, i2, c2, xy2 = pssmlt._chain_steps(pss.scene, pss.cfg, pss.st, chain, t(keys), 0, acc,
                                          1, 0.3)
    moved_j = np.any(np.asarray(ju) != np.asarray(u), axis=0)
    moved = np.any(u2.numpy() != np.asarray(u), axis=0)
    assert (moved == moved_j).mean() >= MIN_LANES and 0.05 < moved.mean() < 0.95
    diff = np.abs(u2.numpy() - np.asarray(ju))
    assert (np.minimum(diff, 1.0 - diff) <= 1e-6).all(axis=0).mean() >= MIN_LANES
    assert frac_close(c2.numpy(), np.asarray(jc2), rtol=LANE_RTOL) >= MIN_LANES
    assert frac_close(xy2.numpy(), np.asarray(jxy2), rtol=1e-5) >= MIN_LANES
    assert frac_close(acc.numpy(), np.asarray(jacc), rtol=LANE_RTOL, atol=1e-5) >= MIN_LANES


def test_pssmlt_bootstrap_seeds(pss):
    """render_pssmlt's bootstrap: b and all of the chains' seed indices
    as the reference draws them (4096 bootstrap paths, the fixture's
    shape)."""
    n_chains, factor = 1024, 4
    kb, kseed, _ = jax.random.split(jax.random.PRNGKey(pss.jcfg.seed), 3)
    u_boot = jax.random.uniform(kb, (pss.dims, factor * n_chains))
    jc, _ = jpssmlt._path_eval(pss.jscene, pss.jcfg, u_boot, pss.jst)
    ji = jluminance(jc)
    probs = ji / jnp.maximum(jnp.sum(ji), 1e-30)
    want = np.asarray(jax.random.choice(kseed, factor * n_chains, shape=(n_chains,), p=probs))

    kb_t, kseed_t, _ = rng.split(rng.base_key(pss.cfg.seed), 3)

    def f_eval(u):
        c, xy = pssmlt._path_eval(pss.scene, pss.cfg, u, pss.st)
        return luminance(c), (c, xy)

    b, idx, u_t, _ = pssmlt.bootstrap((kb_t, kseed_t), pss.dims, factor * n_chains, n_chains,
                                      f_eval)
    np.testing.assert_array_equal(u_t.numpy(), np.asarray(u_boot))
    assert b == pytest.approx(float(jnp.mean(ji)), rel=1e-6)
    # every seed index equal (an ulp of a lane's luminance could move a
    # seed to its neighbour; none does here)
    assert (idx.numpy() == want).sum() == n_chains


def test_render_pssmlt_matches_jax(pss):
    """The bootstrap of 4096 paths, one step of 1024 chains (16x16 x 4
    mutations) and the normalisation."""
    want = jpssmlt.render_pssmlt(pss.jscene, pss.jcfg, n_chains=1024)
    _img_close(pssmlt.render_pssmlt(pss.scene, pss.cfg, n_chains=1024), want)


def test_erpt_redistribute_lanes(pss):
    """256 seeds (the render's pass) and their 4-step chains, the splats
    lane by lane."""
    n = W * H
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.PRNGKey(6),
                                                           jnp.arange(n))
    u = pss.u[:, :n]
    jacc = jerpt._redistribute(pss.jscene, pss.jcfg, pss.jst, u, keys, jnp.zeros((n, 3)), 4)
    acc = erpt._redistribute(pss.scene, pss.cfg, pss.st, t(u), t(keys), torch.zeros((n, 3)), 4)
    assert frac_close(acc.numpy(), np.asarray(jacc), rtol=LANE_RTOL, atol=1e-5) >= MIN_LANES
    assert float(acc.sum()) > 0.0


def test_render_erpt_matches_jax(pss):
    want = jerpt.render_erpt(pss.jscene, pss.jcfg, chain_length=4)
    _img_close(erpt.render_erpt(pss.scene, pss.cfg, chain_length=4), want)


# ---- path-space MLT on the mirror-slab box

class _MLT:
    def __init__(self):
        descs = chain_descs(jscenes)
        self.jscene = j_build_scene(descs["caustic_box"])
        self.scene = port_scene(self.jscene)
        # depth 3: the E-D-S-L paths through the mirror slab
        self.jcfg = JRenderConfig(width=W, height=H, spp=4, max_depth=3, seed=0)
        self.cfg = RenderConfig(width=W, height=H, spp=4, max_depth=3, seed=0)
        self.jst = jmlt._statics(self.jscene, self.jcfg)
        self.st = mlt.scene_statics(self.scene, self.cfg)
        u = jax.random.uniform(jax.random.PRNGKey(3), (2 + 3 * 3, 4096))
        self.u = u
        self.jstate = jmlt._trace_path(self.jscene, self.jcfg, u, self.jst)
        self.state = mlt_state_from_numpy(to_numpy_tree(self.jstate), device="cpu")


@pytest.fixture(scope="module")
def mc():
    return _MLT()


def _assert_state(got, want):
    for f in mlt.MLTState._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        lanes_a = np.moveaxis(a, -1, 0).reshape(a.shape[-1], -1) if f in (
            "vp", "ns", "ng", "prim", "spec", "lobe") else a.reshape(a.shape[0], -1)
        lanes_b = np.moveaxis(b, -1, 0).reshape(b.shape[-1], -1) if f in (
            "vp", "ns", "ng", "prim", "spec", "lobe") else b.reshape(b.shape[0], -1)
        if a.dtype.kind in "bi":
            assert (lanes_a == lanes_b).all(axis=-1).mean() >= MIN_LANES, f
        else:
            assert frac_close(lanes_a, lanes_b, rtol=LANE_RTOL, atol=1e-5) >= MIN_LANES, f


def test_mlt_trace_path_lanes(mc):
    got = mlt._trace_path(mc.scene, mc.cfg, t(mc.u), mc.st)
    _assert_state(got, mc.jstate)
    assert (got.plen.numpy() > 0).mean() > 0.05
    assert got.spec.numpy().any()  # the mirror slab's delta vertices


def test_mlt_eval_chain_lanes(mc):
    P, pdf = mlt._eval_chain(mc.scene, mc.state, mc.cfg, mc.st)
    jP, jpdf = jmlt._eval_chain(mc.jscene, mc.jstate, mc.jcfg, mc.jst)
    assert frac_close(P.numpy(), np.asarray(jP), rtol=LANE_RTOL) >= MIN_LANES
    assert frac_close(pdf.numpy(), np.asarray(jpdf), rtol=LANE_RTOL) >= MIN_LANES


def test_mlt_perturb_lanes(mc):
    ku = jax.random.uniform(jax.random.PRNGKey(4), (9, 4096))
    jprop, jg, jok = jmlt._perturb(mc.jscene, mc.jcfg, mc.jst, mc.jstate, ku)
    prop, g, ok = mlt._perturb(mc.scene, mc.cfg, mc.st, mc.state, t(ku))
    jok = np.asarray(jok)
    assert (ok.numpy() == jok).mean() >= MIN_LANES and jok.sum() > 100
    both = ok.numpy() & jok
    assert frac_close(g.numpy()[both], np.asarray(jg)[both], rtol=LANE_RTOL) >= MIN_LANES
    _assert_state(prop, jprop)


def test_mlt_steps_lanes(mc):
    """A large step (index 0) and a perturbation step (index 1) of 1024
    chains (the render test's count) from the same state: the splats and
    the next states."""
    n = 1024
    jstate = jmlt.MLTState(*(x[..., :n] if f in ("vp", "ns", "ng", "prim", "spec", "lobe")
                             else x[:n] for f, x in zip(jmlt.MLTState._fields, mc.jstate)))
    state = mlt_state_from_numpy(to_numpy_tree(jstate), device="cpu")
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(jax.random.PRNGKey(8),
                                                           jnp.arange(n))
    for step0 in (0, 1):
        jst, jacc = jmlt._chain_steps(mc.jscene, mc.jcfg, mc.jst, jstate, keys, step0,
                                      jnp.zeros((W * H, 3)), 1, 4)
        acc = torch.zeros((W * H, 3))
        st = mlt._chain_steps(mc.scene, mc.cfg, mc.st, state, t(keys), step0, acc, 1, 4)
        _assert_state(st, jst)
        assert frac_close(acc.numpy(), np.asarray(jacc), rtol=LANE_RTOL, atol=1e-5) >= MIN_LANES
        took = np.any(st.vp.numpy() != state.vp.numpy(), axis=(0, 1))
        assert took.mean() > 0.02


def test_render_mlt_matches_jax(mc):
    """The bootstrap, one large step of 1024 chains (16x16 x 4 mutations)
    and the normalisation; test_mlt_steps_lanes holds the perturbation."""
    want = jmlt.render_mlt(mc.jscene, mc.jcfg, n_chains=1024)
    _img_close(mlt.render_mlt(mc.scene, mc.cfg, n_chains=1024), want)


# ---- the CLI's -I

CLI_FUNCS = {"pssmlt": pssmlt.render_pssmlt, "mlt": mlt.render_mlt, "erpt": erpt.render_erpt}


@pytest.mark.parametrize("name", sorted(CLI_FUNCS))
def test_cli_chain_integrators(tmp_path, name):
    out = str(tmp_path / f"{name}.npy")
    assert cli.main(["cornell", "-I", name, "-o", out, "-r", "8x8", "-s", "2", "-d", "3",
                     "--seed", "3", "--device", "cpu"]) == 0
    img = np.load(out)
    scene = build_scene(cornell_box(), device="cpu")
    want = CLI_FUNCS[name](scene, RenderConfig(width=8, height=8, spp=2, max_depth=3, seed=3))
    np.testing.assert_array_equal(img, want.numpy())
    assert np.isfinite(img).all() and img.mean() > 0.0


# ---- slow twins of the JAX package's tests, the port against itself

@pytest.fixture(scope="module")
def port_boxes():
    from mitsuba_path_guiding_torch.scene import scenes

    return {k: build_scene(v, device="cpu") for k, v in chain_descs(scenes).items()}


def _cfg(**kw):
    base = dict(width=16, height=16, spp=16, max_depth=4, seed=0)
    base.update(kw)
    return RenderConfig(**base)


@pytest.mark.slow
def test_eval_chain_matches_trace_twin(port_boxes):
    scene = port_boxes["big_light_box"]
    cfg = _cfg()
    st = mlt.scene_statics(scene, cfg)
    u = rng.uniform_shape(rng.base_key(0), (2 + 3 * cfg.max_depth, 2048))
    s = mlt._trace_path(scene, cfg, u, st)
    ok = s.plen > 0
    assert float(ok.float().mean()) > 0.05
    P2, pdf2 = mlt._eval_chain(scene, s, cfg, st)
    relP = (P2 - s.P).abs().sum(-1) / torch.clamp_min(s.P.sum(-1), 1e-9)
    relp = (pdf2 - s.pdffw).abs() / s.pdffw
    assert float(torch.where(ok, relP, 0.0).max()) < 1e-4
    assert float(torch.where(ok, relp, 0.0).max()) < 1e-4


@pytest.mark.slow
def test_perturbation_structure_and_acceptance_twin(port_boxes):
    scene = port_boxes["caustic_box"]
    cfg = _cfg()
    st = mlt.scene_statics(scene, cfg)
    s = mlt._trace_path(scene, cfg, rng.uniform_shape(rng.base_key(3), (2 + 3 * 4, 4096)), st)
    ok = s.plen > 0
    prop, g, okv = mlt._perturb(scene, cfg, st, s, rng.uniform_shape(rng.base_key(4), (9, 4096)))
    assert torch.equal(prop.plen, s.plen)
    P_p, _ = mlt._eval_chain(scene, prop, cfg, st)
    a = torch.clamp(luminance(P_p) / torch.clamp_min(luminance(s.P), 1e-30) * g, 0.0, 1.0)
    a = torch.where(okv & ok & (luminance(P_p) > 0), a, 0.0)
    live = float(ok.sum())
    assert float((okv & ok).sum()) / live > 0.3
    assert float(a.sum()) / live > 0.25


@pytest.mark.slow
def test_mlt_matches_path_tracer_twin(port_boxes):
    scene = port_boxes["big_light_box"]
    ref = render(scene, _cfg(spp=512, use_nee=False)).numpy()
    img = mlt.render_mlt(scene, _cfg(spp=768, seed=5), n_chains=4096).numpy()
    assert np.isfinite(img).all()
    assert img.mean() == pytest.approx(ref.mean(), rel=0.12)
    rb = ref.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    mb = img.reshape(4, 4, 4, 4, 3).mean(axis=(1, 3))
    assert (np.abs(mb - rb) / np.maximum(rb, 5e-2)).mean() < 0.35


@pytest.mark.slow
def test_mlt_caustic_scene_twin(port_boxes):
    scene = port_boxes["caustic_box"]
    ref = render(scene, _cfg(spp=512, use_nee=False, seed=2)).numpy()
    img = mlt.render_mlt(scene, _cfg(spp=768, seed=7), n_chains=4096).numpy()
    assert np.isfinite(img).all()
    assert img.mean() == pytest.approx(ref.mean(), rel=0.15)


@pytest.mark.slow
def test_path_space_beats_pss_on_caustics_twin(port_boxes):
    scene = port_boxes["caustic_box"]
    ref = render(scene, _cfg(spp=2048, use_nee=False, seed=11)).numpy()
    img_ps = mlt.render_mlt(scene, _cfg(spp=512, seed=3), n_chains=4096).numpy()
    img_pss = pssmlt.render_pssmlt(scene, _cfg(spp=512, seed=3), n_chains=4096).numpy()
    e_ps, e_pss = (float(np.mean((a - ref) ** 2)) for a in (img_ps, img_pss))
    assert e_ps < e_pss, (e_ps, e_pss)


@pytest.mark.slow
def test_pssmlt_matches_forward_twin():
    scene = build_scene(cornell_box(), device="cpu")
    f = render(scene, RenderConfig(width=24, height=24, spp=96, max_depth=4, seed=0)).numpy()
    m = pssmlt.render_pssmlt(scene, RenderConfig(width=24, height=24, spp=96, max_depth=4,
                                                 seed=1), n_chains=4096,
                             bootstrap_factor=8).numpy()
    assert np.isfinite(m).all()
    np.testing.assert_allclose(m.mean(), f.mean(), rtol=0.12)
    assert np.corrcoef(f.mean(-1).ravel(), m.mean(-1).ravel())[0, 1] > 0.9


@pytest.mark.slow
def test_erpt_matches_pt_twin():
    scene = build_scene(cornell_box(), device="cpu")
    img_pt = render(scene, RenderConfig(width=16, height=16, spp=256, max_depth=4, seed=3))
    img_e = erpt.render_erpt(scene, RenderConfig(width=16, height=16, spp=24, max_depth=4,
                                                 seed=11), chain_length=12)
    ratio = float(img_e.mean()) / float(img_pt.mean())
    assert abs(ratio - 1.0) < 0.06, ratio
