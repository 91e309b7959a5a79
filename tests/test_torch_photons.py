"""The port's photon-map integrators against the JAX package on the CPU:
``_cell_coords`` and ``_cell_key``; ``photon_pass`` (the caustic-map
flags too) and ``camera_pass`` lane by lane; ``gather`` on a fixed photon
set, binned and through the narrow-glossy per-photon route;
``render_sppm`` and ``render_photonmapper`` at 16x16;
``volume_photon_pass`` and ``beam_estimate``; the CLI's ``-I
sppm|photonmapper``.  Slow twins of the JAX package's tests
(tests/test_sppm.py, tests/test_photonmapper.py, tests/test_volphoton.py)
hold the port to analytic values, a brute-force count and its own path
tracers with their bars, slow as theirs are.

The JAX gathers unroll every tap when they compile (8 cells x 32 taps,
16 points x 8 cells x 16 taps for the beam), which takes minutes on the
CPU; the fast tests set both packages' tap budgets (``MAX_CELL_TAPS``) to
4 for their run, and the beam's points to 2, so that the two packages
still gather the same photons.  The slow twins run at the real budgets.

Tolerances: per-lane values rtol 1e-4 / atol 1e-6 and flags equal, each
on >= 99% of lanes (XLA on the CPU contracts multiply-adds); images'
means within 1e-3 relative and >= 99% of pixels within 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch import render as cli
from mitsuba_path_guiding_torch.accel.traverse import intersect_brute
from mitsuba_path_guiding_torch.convert import tensors_from_numpy
from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.integrators import photonmapper, sppm, volphoton
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.models import bsdf
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.integrators import photonmapper as jphotonmapper
from mitsuba_path_guiding_tpu.integrators import sppm as jsppm
from mitsuba_path_guiding_tpu.integrators import volphoton as jvolphoton
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.models.bsdf import gather_params as jgather_params
from mitsuba_path_guiding_tpu.models.bsdf import types_present as jtypes_present
from mitsuba_path_guiding_tpu.models.emitter import kinds_present as jkinds_present
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, port_scene, t

W = H = 16
DEPTH = 3
N_PHOTONS = 8192
LANE_RTOL = 1e-4
MIN_LANES = 0.99
IMG_RTOL = 1e-3
FAST_TAPS = 4


def chain_descs(mod):
    from chip_smoke import chain_descs as descs

    return descs(mod)


@pytest.fixture(scope="module")
def few_taps():
    """Both packages' tap budgets at FAST_TAPS for the module's run (the
    JAX package reads its constant when a gather compiles: its compile
    cache is cleared on both sides of the change)."""
    saved = (jsppm.MAX_CELL_TAPS, sppm.MAX_CELL_TAPS, jvolphoton.MAX_CELL_TAPS,
             volphoton.MAX_CELL_TAPS)
    jax.clear_caches()
    jsppm.MAX_CELL_TAPS = sppm.MAX_CELL_TAPS = FAST_TAPS
    jvolphoton.MAX_CELL_TAPS = volphoton.MAX_CELL_TAPS = FAST_TAPS
    yield FAST_TAPS
    (jsppm.MAX_CELL_TAPS, sppm.MAX_CELL_TAPS, jvolphoton.MAX_CELL_TAPS,
     volphoton.MAX_CELL_TAPS) = saved
    jax.clear_caches()


def _img_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and got.shape == want.shape
    assert got.mean() == pytest.approx(float(want.mean()), rel=IMG_RTOL)
    assert frac_close(got, want, rtol=IMG_RTOL, atol=1e-5) >= MIN_LANES


class _Case:
    """One scene in both packages, the reference's first SPPM pass at
    16x16 (N_PHOTONS photons, depth DEPTH) and its hitpoint parameters."""

    def __init__(self, desc):
        self.jscene = j_build_scene(desc)
        self.scene = port_scene(self.jscene)
        self.em_kinds = jkinds_present(self.jscene.emitters)
        self.mat_types = jtypes_present(self.jscene.mats)
        self.kw = dict(em_kinds=self.em_kinds, mat_types=self.mat_types)
        key = jrng.base_key(0)
        pix = jnp.arange(W * H, dtype=jnp.int32)
        self.rk_cam = jrng.ray_keys(key, pix, jnp.zeros_like(pix))
        self.u_pos = jrng.event_uniform(self.rk_cam, 1 << 20, 2)
        self.pix = pix
        self.jhp = jsppm.camera_pass(self.jscene, self.rk_cam, W, H, self.u_pos, pix,
                                     max_depth=DEPTH, sensor_kind=int(self.jscene.sensor.kind),
                                     **self.kw)
        ids = jnp.arange(N_PHOTONS, dtype=jnp.int32) + (1 << 24)
        self.rk_ph = jrng.ray_keys(key, ids, jnp.zeros_like(ids))
        self.jph = jsppm.photon_pass(self.jscene, self.rk_ph, max_depth=DEPTH, **self.kw)
        extent = float(jnp.max(self.jscene.aabb_max - self.jscene.aabb_min))
        self.r = 2.5 * extent / W  # render_sppm's initial radius at 16x16
        self.lo, self.inv_cell, self.G = sppm.grid_params(self.scene, 2.0 * self.r)
        self.narrow = tuple(k for k in jsppm.PER_PHOTON_FAMILIES if k in self.mat_types)


@pytest.fixture(scope="module")
def cases(few_taps):
    descs = chain_descs(jscenes)
    return {name: _Case(descs[name]) for name in ("caustic_box", "glossy_floor")}


def test_cell_coords_and_key():
    p = np.random.default_rng(0).uniform(-1.2, 1.3, (20000, 3)).astype(np.float32)
    lo = np.array([-1.0, -1.0, -1.0], np.float32)
    for G in (1, 7, 512):
        want = jsppm._cell_key(jsppm._cell_coords(jnp.asarray(p), jnp.asarray(lo), 3.7, G), G)
        got = sppm._cell_key(sppm._cell_coords(torch.from_numpy(p), torch.from_numpy(lo), 3.7,
                                               G), G)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["caustic_box", "glossy_floor"])
def test_photon_pass_lanes(cases, name):
    c = cases[name]
    got = sppm.photon_pass(c.scene, t(c.rk_ph), max_depth=DEPTH, **c.kw)
    pos, wi, pw, ok, caus = (x.numpy() for x in got)
    jpos, jwi, jpw, jok, jcaus = (np.asarray(x) for x in c.jph)
    assert ok.shape == jok.shape == (DEPTH * N_PHOTONS,)
    assert (ok == jok).mean() >= MIN_LANES and ok.mean() > 0.1
    both = ok & jok
    for a, b in ((pos, jpos), (wi, jwi), (pw, jpw)):
        assert frac_close(a[both], b[both], rtol=LANE_RTOL) >= MIN_LANES
    assert (caus[both] == jcaus[both]).mean() >= MIN_LANES


def test_caustic_map_flags(cases):
    """No caustic deposit in the all-diffuse box (the JAX package's
    test); the mirror slab's caustic deposits as the reference flags
    them."""
    cornell = build_scene(cornell_box(), device="cpu")
    c = cases["caustic_box"]
    ok, caus = (x.numpy() for x in sppm.photon_pass(
        cornell, t(c.rk_ph), max_depth=DEPTH, mat_types=bsdf.types_present(cornell.mats))[3:])
    assert ok.any() and not (ok & caus).any()
    ok, caus = (x.numpy() for x in sppm.photon_pass(c.scene, t(c.rk_ph), max_depth=DEPTH,
                                                     **c.kw)[3:])
    jok, jcaus = np.asarray(c.jph[3]), np.asarray(c.jph[4])
    assert (ok & caus).sum() > 20
    assert ((ok & caus) == (jok & jcaus)).mean() >= MIN_LANES


@pytest.mark.parametrize("name", ["caustic_box", "glossy_floor"])
def test_camera_pass_lanes(cases, name):
    c = cases[name]
    hp = sppm.camera_pass(c.scene, t(c.rk_cam), W, H, t(c.u_pos), t(c.pix), max_depth=DEPTH,
                          sensor_kind=int(c.scene.sensor.kind), **c.kw)
    for got, want in zip(hp, c.jhp):
        got, want = got.numpy(), np.asarray(want)
        if got.dtype.kind in "bi":
            assert (got == want).mean() >= MIN_LANES
        else:
            assert frac_close(got, want, rtol=LANE_RTOL) >= MIN_LANES
    assert hp.valid.numpy().mean() > 0.5


@pytest.mark.parametrize("name", ["caustic_box", "glossy_floor"])
def test_gather_matches_jax(cases, name):
    """The first pass's gather on the reference's photons and hitpoints:
    the counts, the binned flux (caustic_box: diffuse, with the mirror's
    caustic deposits) and (glossy_floor: rough conductor of alpha 0.06)
    the per-photon route's flux."""
    c = cases[name]
    jhp = c.jhp
    R = jnp.full((W * H,), c.r, jnp.float32)
    hp_p = jgather_params(c.jscene.mats, jhp[6]) if c.narrow else None
    want = jsppm.gather(jhp[0], jhp[1], R, *c.jph[:4], c.jscene.aabb_min, c.inv_cell, c.G,
                        hp_p=hp_p, hp_wol=jhp[7], narrow_types=c.narrow)
    hp_pos, hp_ns, hp_mid, hp_wol = tensors_from_numpy(
        [np.asarray(jhp[k]) for k in (0, 1, 6, 7)], device="cpu")
    php = bsdf.gather_params(c.scene.mats, hp_mid, types=bsdf.types_present(c.scene.mats))
    ph = tensors_from_numpy([np.asarray(x) for x in c.jph[:4]], device="cpu")
    got = sppm.gather(hp_pos, hp_ns, t(R), *ph, c.lo, c.inv_cell, c.G, hp_p=php, hp_wol=hp_wol,
                      narrow_types=c.narrow)
    count, phi, phi_pp = (np.asarray(x) for x in want)
    assert (got[0].numpy() == count).mean() >= MIN_LANES and count.max() > 1
    assert frac_close(got[1].numpy().reshape(W * H, -1), phi.reshape(W * H, -1),
                      rtol=LANE_RTOL) >= MIN_LANES
    assert frac_close(got[2].numpy(), phi_pp, rtol=LANE_RTOL) >= MIN_LANES
    if c.narrow:
        assert phi_pp.max() > 0.0


def test_render_sppm_matches_jax(cases):
    """Two passes on the glossy floor (both gather routes)."""
    c = cases["glossy_floor"]
    kw = dict(n_iterations=2, photons_per_iter=N_PHOTONS)
    want = jsppm.render_sppm(c.jscene, JRenderConfig(width=W, height=H, spp=1,
                                                     max_depth=DEPTH), **kw)
    _img_close(sppm.render_sppm(c.scene, RenderConfig(width=W, height=H, spp=1,
                                                      max_depth=DEPTH), **kw), want)


def test_render_photonmapper_matches_jax(cases):
    """The caustic box: global and caustic maps, two camera samples."""
    c = cases["caustic_box"]
    want = jphotonmapper.render_photonmapper(
        c.jscene, JRenderConfig(width=W, height=H, spp=2, max_depth=DEPTH), n_photons=N_PHOTONS)
    _img_close(photonmapper.render_photonmapper(
        c.scene, RenderConfig(width=W, height=H, spp=2, max_depth=DEPTH), n_photons=N_PHOTONS),
        want)


# ---- the volume photon map

@pytest.fixture(scope="module")
def medium(few_taps):
    jscene = j_build_scene(chain_descs(jscenes)["medium_box"])
    return jscene, port_scene(jscene)


def _volume_photons(jscene, n=4096, depth=4):
    rk = jrng.ray_keys(jrng.base_key(5), jnp.zeros((n,), jnp.int32), jnp.arange(n))
    em = jkinds_present(jscene.emitters)
    return rk, jvolphoton.volume_photon_pass(jscene, rk, max_depth=depth, em_kinds=em), em


def test_volume_photon_pass_lanes(medium):
    jscene, scene = medium
    rk, want, em = _volume_photons(jscene)
    pos, wdir, pw, ok = (x.numpy() for x in volphoton.volume_photon_pass(
        scene, t(rk), max_depth=4, em_kinds=em))
    jpos, jwdir, jpw, jok = (np.asarray(x) for x in want)
    assert (ok == jok).mean() >= MIN_LANES and ok.mean() > 0.05
    both = ok & jok
    for a, b in ((pos, jpos), (wdir, jwdir), (pw, jpw)):
        assert frac_close(a[both], b[both], rtol=LANE_RTOL) >= MIN_LANES


def test_beam_estimate_matches_jax(medium):
    """The beam estimate at 2 points a segment on 1024 rays from the
    camera through the medium, on the reference's photons."""
    jscene, scene = medium
    _, (ph_pos, ph_dir, ph_pw, ph_ok), _ = _volume_photons(jscene)
    n, r, n_taps = 1024, 0.12, 2
    rs = np.random.default_rng(0)
    o = np.tile(np.array([0.0, 0.0, -1.9], np.float32), (n, 1))
    ang = rs.uniform(-0.45, 0.45, (n, 2))
    d = np.stack([np.sin(ang[:, 0]), np.sin(ang[:, 1]) * 0.3, np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    hit = intersect_brute(scene.geo, torch.from_numpy(o), torch.from_numpy(d))
    t_seg = torch.where(hit.valid, hit.t, 4.0)
    taps = rs.random((n_taps, n)).astype(np.float32)
    lo, inv_cell, g = volphoton.build_vol_grid(scene, r)
    want = jvolphoton.beam_estimate(jscene, jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(t_seg.numpy()), jnp.asarray(taps), ph_pos, ph_dir,
                                    ph_pw, ph_ok, jscene.aabb_min, inv_cell, g, r,
                                    n_emitted=4096, n_taps=n_taps)
    ph = tensors_from_numpy([np.asarray(x) for x in (ph_pos, ph_dir, ph_pw, ph_ok)],
                            device="cpu")
    got = volphoton.beam_estimate(scene, torch.from_numpy(o), torch.from_numpy(d), t_seg,
                                  torch.from_numpy(taps), *ph, lo, inv_cell, g, r,
                                  n_emitted=4096, n_taps=n_taps)
    assert frac_close(got.numpy(), np.asarray(want), rtol=LANE_RTOL, atol=1e-7) >= MIN_LANES
    assert float(got.mean()) > 0.0


# ---- the CLI's -I

CLI_FUNCS = {"sppm": (sppm, "render_sppm", {"photons_per_iter": 8192}),
             "photonmapper": (photonmapper, "render_photonmapper", {"n_photons": 8192})}


@pytest.mark.parametrize("name", sorted(CLI_FUNCS))
def test_cli_photon_integrators(tmp_path, monkeypatch, name):
    """The CLI hands -I sppm|photonmapper its config and writes the render
    function's image.  The function is wrapped to record its config and
    render with 8192 photons (the CLI's own 131072, eight passes of them
    for SPPM, render in tests/test_torch_aux_integrators.py)."""
    mod, fname, kw = CLI_FUNCS[name]
    real, seen = getattr(mod, fname), []

    def recording(scene, cfg):
        img = real(scene, cfg, **kw)
        seen.append((cfg, img))
        return img

    monkeypatch.setattr(mod, fname, recording)
    out = str(tmp_path / f"{name}.npy")
    assert cli.main(["cornell", "-I", name, "-o", out, "-r", "4x4", "-s", "2", "-d", "2",
                     "--seed", "3", "--device", "cpu"]) == 0
    (cfg, want), = seen
    assert cfg == RenderConfig(width=4, height=4, spp=2, max_depth=2, rr_depth=5, seed=3)
    img = np.load(out)
    np.testing.assert_array_equal(img, want.numpy())
    assert np.isfinite(img).all() and img.mean() > 0.0


# ---- slow twins of the JAX package's tests, the port against itself

@pytest.fixture(scope="module")
def port_descs():
    from mitsuba_path_guiding_torch.scene import scenes

    return chain_descs(scenes)


@pytest.mark.slow
def test_photon_density_matches_analytic_twin(port_descs):
    scene = build_scene(port_descs["floor_point"], device="cpu")
    n = 1 << 16
    rk = rng.ray_keys(rng.base_key(0), torch.arange(n), torch.zeros(n, dtype=torch.int64))
    pos, _, pw, ok, _ = (x.numpy() for x in sppm.photon_pass(scene, rk, max_depth=1))
    r = 0.3
    sel = ok & (pos[:, 0] ** 2 + pos[:, 2] ** 2 <= r * r) & (np.abs(pos[:, 1]) < 1e-3)
    E = pw[sel].sum(axis=0)[0] / n / (np.pi * r * r)
    np.testing.assert_allclose(E, 8.0 / 2.5**2, rtol=0.08)


@pytest.mark.slow
def test_grid_gather_matches_brute_twin(port_descs):
    scene = build_scene(port_descs["floor_point"], device="cpu")
    n = 1 << 15
    rk = rng.ray_keys(rng.base_key(3), torch.arange(n), torch.zeros(n, dtype=torch.int64))
    pos, wi, pw, ok, _ = sppm.photon_pass(scene, rk, max_depth=2)
    r = 0.25
    hps = torch.tensor([[0.0, 0.0, 0.0], [0.7, 0.0, -0.4], [1.9, 0.0, 1.9]])
    ns = torch.tensor([[0.0, 1.0, 0.0]]).expand(3, 3)
    lo, inv_cell, G = sppm.grid_params(scene, 2 * r)
    cnt, _, _ = sppm.gather(hps, ns, torch.full((3,), r), pos, wi, pw, ok, lo, inv_cell, G)
    posn, okn = pos.numpy(), ok.numpy()
    for i, hp in enumerate(hps.numpy()):
        d2 = ((posn - hp) ** 2).sum(-1)
        sel = okn & (d2 <= r * r) & (np.abs(posn[:, 1] - hp[1]) <= 0.1 * r)
        np.testing.assert_allclose(float(cnt[i]), sel.sum(), rtol=0.35, atol=3.0)


def _sppm_vs_forward(desc, res, spp_f, depth, seed, iters, rtol, corr_bar=None):
    scene = build_scene(desc, device="cpu")
    f = render(scene, RenderConfig(width=res, height=res, spp=spp_f, max_depth=depth,
                                   seed=seed)).numpy()
    s = sppm.render_sppm(scene, RenderConfig(width=res, height=res, spp=1, max_depth=depth,
                                             seed=seed), n_iterations=iters,
                         photons_per_iter=1 << 15).numpy()
    assert np.isfinite(s).all()
    np.testing.assert_allclose(s.mean(), f.mean(), rtol=rtol)
    if corr_bar is not None:
        assert np.corrcoef(f.mean(-1).ravel(), s.mean(-1).ravel())[0, 1] > corr_bar


@pytest.mark.slow
def test_sppm_matches_forward_direct_twin(port_descs):
    _sppm_vs_forward(port_descs["floor_point"], 24, 64, 2, 1, 5, 0.08)


@pytest.mark.slow
def test_sppm_matches_forward_cornell_twin(port_descs):
    _sppm_vs_forward(port_descs["cornell"], 24, 96, 5, 0, 6, 0.12, 0.95)


@pytest.mark.slow
def test_sppm_glossy_gather_matches_forward_twin():
    from mitsuba_path_guiding_torch.scene import scenes

    desc = scenes.cornell_box()
    desc["shapes"][0]["bsdf"] = {"type": "roughconductor", "alpha": 0.25, "material": "none",
                                 "specular_reflectance": [0.9, 0.9, 0.9]}
    _sppm_vs_forward(desc, 24, 128, 4, 0, 6, 0.2, 0.9)


@pytest.mark.slow
def test_sppm_narrow_glossy_per_photon_eval_twin(port_descs):
    _sppm_vs_forward(port_descs["glossy_floor"], 24, 192, 4, 0, 8, 0.2, 0.9)


@pytest.mark.slow
def test_photonmapper_matches_pt_twin(port_descs):
    scene = build_scene(port_descs["cornell"], device="cpu")
    img_pt = render(scene, RenderConfig(width=16, height=16, spp=256, max_depth=4, seed=3))
    img_pm = photonmapper.render_photonmapper(
        scene, RenderConfig(width=16, height=16, spp=24, max_depth=4, seed=5), n_photons=1 << 16)
    assert np.isfinite(img_pm.numpy()).all()
    ratio = float(img_pm.mean()) / float(img_pt.mean())
    assert 0.80 < ratio < 1.20, ratio


@pytest.mark.slow
def test_volume_photons_match_volpath_twin(port_descs):
    from mitsuba_path_guiding_torch.integrators.volpath import trace_vol
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    scene = build_scene(port_descs["medium_box"], device="cpu")
    n_ph, n_waves, r = 1 << 16, 6, 0.12
    lo, inv_cell, g = volphoton.build_vol_grid(scene, r)
    em = kinds_present(scene.emitters)
    deps = []
    for w in range(n_waves):
        rk = rng.ray_keys(rng.base_key(5), torch.zeros(n_ph, dtype=torch.int64),
                          torch.arange(w * n_ph, (w + 1) * n_ph))
        deps.append(volphoton.volume_photon_pass(scene, rk, max_depth=6, em_kinds=em))
    ph_pos, ph_dir, ph_pw, ph_ok = (torch.cat(x) for x in zip(*deps))
    assert float(ph_ok.float().mean()) > 0.05
    n = 4096
    rs = np.random.default_rng(0)
    o = np.tile(np.array([0.0, 0.0, -1.9], np.float32), (n, 1))
    ang = rs.uniform(-0.45, 0.45, (n, 2))
    d = np.stack([np.sin(ang[:, 0]), np.sin(ang[:, 1]) * 0.3, np.ones(n)], -1)
    o = torch.from_numpy(o)
    d = torch.from_numpy((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    hit = intersect_brute(scene.geo, o, d)
    t_seg = torch.where(hit.valid, hit.t, 4.0)
    taps = torch.from_numpy(rs.random((16, n)).astype(np.float32))
    L_beam = volphoton.beam_estimate(scene, o, d, t_seg, taps, ph_pos, ph_dir, ph_pw, ph_ok,
                                     lo, inv_cell, g, r, n_emitted=n_ph * n_waves, n_taps=16)
    acc = torch.zeros((n, 3))
    for s in range(24):
        rk = rng.ray_keys(rng.base_key(91), torch.arange(n), torch.full((n,), s))
        acc = acc + trace_vol(scene, o, d, rk, max_depth=6, em_kinds=em,
                              mat_types=bsdf.types_present(scene.mats))[0]
    a, b = float(L_beam.mean()), float((acc / 24).mean())
    assert b > 1e-4
    assert abs(a / b - 1.0) < 0.15, (a, b)
