"""The port's phase functions, media and guided distance sampling against
the JAX package on the CPU, and twins of the JAX package's volume tests
(tests/test_volpath.py, tests/test_medium.py, tests/test_guided_distance.py)
run on the port alone.

Tolerances: per-lane values rtol 1e-5 on >= 99% of 4096 lanes (XLA on
the CPU contracts a*b+c into one rounding, the port rounds each step);
directions drawn through a cube root (Rayleigh, the mixture's Rayleigh
components) rtol 1e-4, torch having no ``cbrt`` (the port takes
sign(x) |x|^(1/3)); ids, flags and compiled arrays exactly.  The tracking
loops on the same keys: t and the event flag equal on >= 99% of lanes,
weights rtol 1e-4 on >= 99%."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.core import chi2
from mitsuba_path_guiding_torch.core import rng as trng
from mitsuba_path_guiding_torch.guiding import distance as tdist
from mitsuba_path_guiding_torch.guiding.grid import make_grid
from mitsuba_path_guiding_torch.models import medium as tmed
from mitsuba_path_guiding_torch.models import phase as tph
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene import volume as tvol
from mitsuba_path_guiding_torch.scene.builder import _compile_medium, build_scene
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.guiding import distance as jdist
from mitsuba_path_guiding_tpu.guiding.grid import make_grid as j_make_grid
from mitsuba_path_guiding_tpu.models import medium as jmed
from mitsuba_path_guiding_tpu.models import phase as jph
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene import volume as jvolume
from mitsuba_path_guiding_tpu.scene.builder import _compile_medium as j_compile_medium
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, port_grid, t, to_numpy_tree

N = 4096
N_CHI2 = 150_000
WI = (0.36, -0.48, 0.8)


def _t_medium(spec):
    return _compile_medium(spec, lambda a, dtype=torch.float32: torch.as_tensor(
        np.array(a), dtype=dtype))


def _media(spec):
    """The JAX package's and the port's compile of one medium dict."""
    from mitsuba_path_guiding_torch.convert import _fill
    from mitsuba_path_guiding_torch.scene.types import MediumData

    jm = j_compile_medium(spec)
    tm = _t_medium(spec)
    conv = _fill(MediumData, to_numpy_tree(jm), "cpu",
                 host=("enabled", "heterogeneous", "phase_kind"))
    return jm, tm, conv


FIBER = {"sigma_a": [0.1] * 3, "sigma_s": [0.5] * 3, "orientation": [0.3, 0.5, 0.81]}
PHASES = {
    "hg": {"sigma_a": [0.1] * 3, "sigma_s": [0.5] * 3, "g": 0.6},
    "isotropic": {"sigma_a": [0.1] * 3, "sigma_s": [0.5] * 3, "phase": "isotropic"},
    "rayleigh": {"sigma_a": [0.1] * 3, "sigma_s": [0.5] * 3, "phase": "rayleigh"},
    "kkay": {**FIBER, "phase": "kkay", "ks": 0.4, "kd": 0.2, "exponent": 4.0},
    "microflake": {**FIBER, "phase": "microflake", "stddev": 0.25},
    "mixture": {"sigma_a": [0.1] * 3, "sigma_s": [0.5] * 3, "phase": "mixture",
                "phase_weights": [0.5, 0.3, 0.2],
                "phase_components": [{"type": "hg", "g": 0.7}, {"type": "rayleigh"},
                                     {"type": "hg", "g": -0.4}]},
}


def _dirs(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(PHASES))
def test_medium_compiles_equal_to_reference(name):
    """Every field of MediumData, the converted one too, equal array for
    array."""
    jm, tm, conv = _media(PHASES[name])
    for got in (tm, conv):
        for f in jm._fields:
            a, b = getattr(jm, f), getattr(got, f)
            if a is None:
                assert b is None, f
            elif isinstance(a, (bool, int)):
                assert a == b, f
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_eval_sample_match_reference(name):
    """eval, and sample's direction, pdf and weight, of each family on
    4096 lanes of numpy-made directions and uniforms."""
    jm, tm, _ = _media(PHASES[name])
    kind = tm.phase_kind
    rs = np.random.RandomState(3)
    wi, wo = _dirs(rs, N), _dirs(rs, N)
    u = rs.rand(N, 2).astype(np.float32)
    g = float(np.asarray(jm.phase_g))
    ev_j = np.asarray(jph.phase_eval_kind(jnp.asarray(wi), jnp.asarray(wo), jm.phase_g, kind, jm))
    ev_t = tph.phase_eval_kind(t(wi), t(wo), tm.phase_g, kind, tm).numpy()
    assert frac_close(ev_t, ev_j, rtol=1e-5) >= 0.99
    wo_j, pdf_j, w_j = (np.asarray(x) for x in jph.phase_sample_kind_w(
        jnp.asarray(wi), jm.phase_g, jnp.asarray(u), kind, jm))
    wo_t, pdf_t, w_t = (x.numpy() for x in tph.phase_sample_kind_w(
        t(wi), tm.phase_g, t(u), kind, tm))
    rtol = 1e-4 if name in ("rayleigh", "mixture") else 1e-5
    assert frac_close(wo_t, wo_j, rtol=rtol, atol=1e-5) >= 0.99
    assert frac_close(pdf_t, pdf_j, rtol=rtol) >= 0.99
    assert frac_close(w_t, w_j, rtol=rtol) >= 0.99
    assert np.isfinite(wo_t).all() and g == float(tm.phase_g)


def test_microflake_streams_match_reference():
    """The rejection rounds' keys: the two uniforms hashed to a uint32 seed,
    48 uniforms of key (0, seed), as jax.random.uniform(PRNGKey(seed),
    (16, 3)), bit for bit on 4096 lanes; the accepted round and the
    acceptance flags equal."""
    rs = np.random.RandomState(5)
    u = rs.rand(N, 2).astype(np.float32)
    bits = (u * np.float32(1 << 23)).astype(np.uint32)
    seed = bits[:, 0] ^ (bits[:, 1] << np.uint32(9))
    want = np.asarray(jax.vmap(lambda s: jax.random.uniform(jax.random.PRNGKey(s), (16, 3)))(
        jnp.asarray(seed)))
    ub = (t(u) * float(1 << 23)).to(torch.int64)
    st = (ub[:, 0] ^ (ub[:, 1] << 9)) & trng.MASK32
    got = trng.uniform(torch.stack([torch.zeros_like(st), st], dim=-1), 48).reshape(N, 16, 3)
    np.testing.assert_array_equal(st.numpy(), seed.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(), want)
    jm, tm, _ = _media(PHASES["microflake"])
    wi = _dirs(rs, N)
    _, _, w_j = jph.phase_sample_kind_w(jnp.asarray(wi), 0.0, jnp.asarray(u), 3, jm)
    _, _, w_t = tph.phase_sample_kind_w(t(wi), 0.0, t(u), 3, tm)
    assert (w_t.numpy() == np.asarray(w_j)).mean() >= 0.999


def _sphere_grid(nt, nh):
    th = (np.arange(nt) + 0.5) / nt * np.pi
    h = (np.arange(nh) + 0.5) / nh * 2 * np.pi
    TT, HH = np.meshgrid(th, h, indexing="ij")
    d = np.stack([np.sin(TT) * np.cos(HH), np.sin(TT) * np.sin(HH), np.cos(TT)], -1)
    dA = (np.pi / nt) * (2 * np.pi / nh) * np.sin(TT)
    return torch.from_numpy(d.reshape(-1, 3).astype(np.float32)), dA


def _chi2(wo, pdf_fn, **kw):
    passed, _, msg = chi2.chi2_test_sphere(wo, pdf_fn, **kw)
    assert passed, msg


@pytest.mark.parametrize("g", [0.0, 0.4, -0.6, 0.9])
def test_hg_chi2(g):
    """Twin of tests/test_volpath.py::test_phase_chi2."""
    wi = torch.tensor(WI).expand(N_CHI2, 3)
    u = trng.uniform(trng.base_key(int(g * 10) + 5), N_CHI2 * 2).reshape(N_CHI2, 2)
    wo, _ = tph.phase_sample(wi, torch.full((N_CHI2,), g), u)
    _chi2(wo.numpy(), lambda dirs: tph.phase_eval(
        torch.tensor(WI).expand(len(dirs), 3), torch.from_numpy(dirs),
        torch.full((len(dirs),), g)).numpy())


def test_phase_normalization():
    """Twin of tests/test_volpath.py::test_phase_normalization, with the
    microflake's (test_microflake_normalization) and the kd-only share of
    Kajiya-Kay (test_kkay_normalized_and_weighted)."""
    d, dA = _sphere_grid(512, 1024)
    m = d.shape[0]
    wi = torch.tensor([0.0, 0.0, 1.0]).expand(m, 3)
    for g in (0.0, 0.9, -0.9):
        pv = tph.phase_eval(wi, d, torch.full((m,), g)).numpy().reshape(dA.shape)
        assert abs((pv * dA).sum() - 1.0) < 2e-3, g
    for name, axis_wi, lo, hi in (("microflake_n", (0.6, 0.0, 0.8), 0.98, 1.02),
                                  ("kkay", (0.8, 0.0, 0.6), 0.45, 0.75)):
        spec = ({**FIBER, "phase": "microflake", "stddev": 0.3} if name == "microflake_n"
                else PHASES["kkay"])
        med = _t_medium(spec)
        pv = tph.phase_eval_kind(torch.tensor(axis_wi).expand(m, 3), d, 0.0, med.phase_kind,
                                 med).numpy().reshape(dA.shape)
        assert lo < (pv * dA).sum() < hi, (name, (pv * dA).sum())


def test_kkay_weight_is_eval_over_pdf():
    """Twin of test_kkay_normalized_and_weighted's weight check."""
    med = _t_medium(PHASES["kkay"])
    n = 8192
    u = trng.uniform(trng.base_key(0), 2 * n).reshape(n, 2)
    wi = torch.tensor([0.8, 0.0, 0.6]).expand(n, 3)
    wo, pdf, w = tph.phase_sample_kind_w(wi, 0.0, u, tph.PhaseKind.KKAY, med)
    ev = tph.phase_eval_kind(wi, wo, 0.0, tph.PhaseKind.KKAY, med)
    np.testing.assert_allclose(w.numpy(), (ev / pdf).numpy(), rtol=1e-4)


@pytest.mark.parametrize("name", ["rayleigh", "microflake", "mixture"])
def test_phase_family_chi2(name):
    """Twins of test_rayleigh_chi2, test_microflake_chi2 and
    test_mixture_phase_chi2: eval == pdf where the family is sampled
    exactly, and the chi-square test of the sampled directions."""
    spec = PHASES[name] if name != "microflake" else {**FIBER, "phase": "microflake",
                                                      "stddev": 0.25}
    med = _t_medium(spec)
    wi = torch.tensor(WI).expand(N_CHI2, 3)
    seed = {"rayleigh": 11, "microflake": 7, "mixture": 41}[name]
    u = trng.uniform(trng.base_key(seed), 2 * N_CHI2).reshape(N_CHI2, 2)
    wo, pdf, w = tph.phase_sample_kind_w(wi, med.phase_g, u, med.phase_kind, med)
    ok = w.numpy() > 0
    if name == "microflake":
        assert ok.mean() > 0.98, ok.mean()
    else:
        np.testing.assert_allclose(pdf.numpy(), tph.phase_eval_kind(
            wi, wo, med.phase_g, med.phase_kind, med).numpy(), rtol=1e-5)

    def pdf_fn(dirs):
        return tph.phase_eval_kind(torch.tensor(WI).expand(len(dirs), 3), torch.from_numpy(dirs),
                                   med.phase_g, med.phase_kind, med).numpy()

    _chi2(wo.numpy()[ok], pdf_fn, sample_count=N_CHI2)


def test_hg_forward_peak_convention():
    """Twin of tests/test_volpath.py::test_hg_forward_peak_convention."""
    d = torch.tensor([0.0, 0.0, 1.0]).expand(20000, 3)
    u = trng.uniform(trng.base_key(0), 40000).reshape(20000, 2)
    wo, _ = tph.phase_sample(-d, torch.full((20000,), 0.9), u)
    assert float(torch.mean(torch.sum(wo * d, -1))) > 0.85


def test_microflake_extinction_is_directional():
    """The first half of tests/test_volpath.py::
    test_microflake_directional_extinction: the projected flake area, and
    so sigma_t, is smallest along the fiber axis."""
    med = _t_medium({**FIBER, "phase": "microflake", "stddev": 0.25})
    along = float(tph._mf_sigma_t(med.sigt_table, torch.tensor([1.0]))[0])
    across = float(tph._mf_sigma_t(med.sigt_table, torch.tensor([0.0]))[0])
    assert along < across, (along, across)


# ---------------------------------------------------------------------------
# grid media
# ---------------------------------------------------------------------------

def _cloud_spec(res=24, sigma_s=0.7, sigma_a=0.2):
    z, y, x = np.meshgrid(*(np.linspace(0, 1, res),) * 3, indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    dens = np.clip(1.0 - 2.0 * r, 0.0, 1.0) ** 2
    return {"sigma_s": [sigma_s] * 3, "sigma_a": [sigma_a] * 3,
            "density": dens.astype(np.float32), "bounds": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))}, dens


@pytest.fixture(scope="module")
def cloud():
    spec, dens = _cloud_spec()
    jm, tm, _ = _media(spec)
    return jm, tm, dens


def test_density_at_matches_reference(cloud):
    """On the grid's nodes (exactly, the JAX test's nodes too) and at 4096
    random points in and around the box (rtol 1e-5)."""
    jm, tm, dens = cloud
    res = dens.shape[0]
    idx = np.array([[3, 5, 7], [0, 0, 0], [res - 1] * 3, [8, 2, 11]])
    p = (idx[:, ::-1] / (res - 1)).astype(np.float32)
    got = tmed.density_at(tm, t(p)).numpy()
    np.testing.assert_allclose(got, dens[idx[:, 0], idx[:, 1], idx[:, 2]], rtol=2e-5, atol=2e-6)
    np.testing.assert_array_equal(got, np.asarray(jmed.density_at(jm, jnp.asarray(p))))
    assert float(tmed.density_at(tm, torch.tensor([[2.0, 0.5, 0.5]]))[0]) == 0.0
    pr = np.random.RandomState(1).uniform(-0.2, 1.2, (N, 3)).astype(np.float32)
    assert frac_close(tmed.density_at(tm, t(pr)).numpy(),
                      np.asarray(jmed.density_at(jm, jnp.asarray(pr))), rtol=1e-5) >= 0.99


def test_point_queries(cloud):
    """Twin of tests/test_medium.py::test_point_queries_fork_parity."""
    _, tm, _ = cloud
    p = torch.tensor([[0.5, 0.5, 0.5], [0.1, 0.9, 0.4]])
    d = tmed.density_at(tm, p).numpy()
    np.testing.assert_allclose(tmed.get_sigma_t(tm, p).numpy(), np.tile(d[:, None] * 0.9, (1, 3)),
                               rtol=1e-5)
    np.testing.assert_allclose(tmed.get_sigma_s(tm, p).numpy(), np.tile(d[:, None] * 0.7, (1, 3)),
                               rtol=1e-5)
    np.testing.assert_allclose(tmed.get_sigma_a(tm, p).numpy(), np.tile(d[:, None] * 0.2, (1, 3)),
                               rtol=1e-5)
    np.testing.assert_allclose(tmed.get_albedo(tm, p).numpy(), np.full((2, 3), 0.7 / 0.9),
                               rtol=1e-5)


def test_track_keys_match_reference():
    """_track_keys (salt + depth folded into each key) and _step_uniform
    (the step folded in, then uniform(key, (n,))) bit for bit on 4096
    keys."""
    pix = np.arange(N, dtype=np.int32)
    kj = jrng.ray_keys(jrng.base_key(4), jnp.asarray(pix), jnp.zeros(N, jnp.int32))
    kt = t(kj)
    for depth, salt in ((0, 2 << 20), (3, 3 << 20), (5, (2 << 20) + 7)):
        tkj = jmed._track_keys(kj, jnp.int32(depth), salt)
        tkt = tmed._track_keys(kt, depth, salt)
        np.testing.assert_array_equal(tkt.numpy(), np.asarray(tkj).astype(np.int64))
        for it, n in ((0, 2), (17, 1), (2047, 2)):
            np.testing.assert_array_equal(tmed._step_uniform(tkt, it, n).numpy(),
                                          np.asarray(jmed._step_uniform(tkj, jnp.int32(it), n)))


def test_tracking_loops_match_reference():
    """sample_free_flight and transmittance_ratio on 4096 rays aimed through
    a dense cloud from numpy-made origins, the same keys: t and the event
    flag equal on >= 99% of lanes, weights rtol 1e-4."""
    jm, tm, _ = _media(_cloud_spec(sigma_s=3.0, sigma_a=1.0)[0])
    rs = np.random.RandomState(2)
    o = (0.5 + 0.9 * _dirs(rs, N)).astype(np.float32)
    aim = 0.5 + rs.uniform(-0.25, 0.25, (N, 3)) - o
    d = (aim / np.linalg.norm(aim, axis=-1, keepdims=True)).astype(np.float32)
    tmax = rs.uniform(0.0, 2.5, N).astype(np.float32)
    tmax[::7] = 3.0e37
    kj = jrng.ray_keys(jrng.base_key(9), jnp.arange(N, dtype=jnp.int32), jnp.zeros(N, jnp.int32))
    tkj = jmed._track_keys(kj, jnp.int32(1), 2 << 20)
    tkt = t(tkj)
    t_j, m_j, w_j = (np.asarray(x) for x in jmed.sample_free_flight(
        jm, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), tkj))
    t_t, m_t, w_t = (x.numpy() for x in tmed.sample_free_flight(tm, t(o), t(d), t(tmax), tkt))
    assert m_j.mean() > 0.05 and (~m_j).mean() > 0.05
    assert (m_t == m_j).mean() >= 0.99
    assert frac_close(t_t, t_j, rtol=1e-4) >= 0.99
    assert frac_close(w_t, w_j, rtol=1e-4) >= 0.99
    tr_j = np.asarray(jmed.transmittance_ratio(jm, jnp.asarray(o), jnp.asarray(d),
                                               jnp.asarray(tmax), tkj))
    tr_t = tmed.transmittance_ratio(tm, t(o), t(d), t(tmax), tkt).numpy()
    assert 0.05 < tr_j.mean() < 0.99
    assert frac_close(tr_t, tr_j, rtol=1e-4) >= 0.99


def test_tracking_stops_at_the_step_cap(cloud, monkeypatch):
    """MAX_TRACK_STEPS bounds the loop exactly, whatever ANY_EVERY is."""
    _, tm, _ = cloud
    calls = []
    real = tmed._step_uniform
    monkeypatch.setattr(tmed, "MAX_TRACK_STEPS", 5)
    monkeypatch.setattr(tmed, "_step_uniform", lambda k, it, n: calls.append(it) or real(k, it, n))
    o = torch.tensor([[0.5, 0.5, -0.5]]).expand(64, 3)
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(64, 3)
    keys = trng.ray_keys(trng.base_key(0), torch.arange(64), torch.zeros(64, dtype=torch.int64))
    tmed.transmittance_ratio(tm._replace(majorant=tm.majorant * 1e3), o, d,
                             torch.full((64,), 2.0), keys)
    assert calls == [0, 1, 2, 3, 4]


def _quadrature_tr(med, o, d, t_max, n=4096):
    ts = (np.arange(n) + 0.5) / n * t_max
    pts = o[None, :] + ts[:, None] * d[None, :]
    dens = tmed.density_at(med, torch.from_numpy(pts.astype(np.float32))).numpy()
    base = (med.sigma_a + med.sigma_s).numpy()
    return np.exp(-dens.sum() * (t_max / n) * base)


@pytest.mark.parametrize("seed", [0, 1])
def test_ratio_tracking_unbiased(seed):
    """Twin of tests/test_medium.py::test_ratio_tracking_unbiased."""
    med = _t_medium(_cloud_spec()[0])
    o = np.array([0.5, 0.45, -0.5], np.float32)
    d = np.array([0.0, 0.05, 1.0], np.float32)
    d /= np.linalg.norm(d)
    want = _quadrature_tr(med, o, d, 2.0)
    n = 20000
    keys = trng.ray_keys(trng.base_key(seed), torch.arange(n), torch.zeros(n, dtype=torch.int64))
    w = tmed.transmittance_ratio(med, t(o).expand(n, 3), t(d).expand(n, 3), torch.full((n,), 2.0),
                                 tmed._track_keys(keys, 0, 0)).numpy()
    np.testing.assert_allclose(w.mean(axis=0), want, rtol=0.03)


def test_free_flight_pass_probability():
    """Twin of tests/test_medium.py::test_free_flight_pass_probability."""
    med = _t_medium(_cloud_spec(sigma_s=0.0, sigma_a=1.5)[0])
    o = np.array([0.5, 0.5, -0.5], np.float32)
    d = np.array([0.0, 0.0, 1.0], np.float32)
    want = _quadrature_tr(med, o, d, 2.0)
    n = 20000
    keys = trng.ray_keys(trng.base_key(7), torch.arange(n), torch.zeros(n, dtype=torch.int64))
    _, is_med, w = tmed.sample_free_flight(med, t(o).expand(n, 3), t(d).expand(n, 3),
                                           torch.full((n,), 2.0), tmed._track_keys(keys, 0, 0))
    got = (w.numpy() * (~is_med.numpy())[:, None]).mean(axis=0)
    np.testing.assert_allclose(got, want, rtol=0.04)


def test_vol_file_roundtrip(tmp_path):
    """Twin of tests/test_medium.py::test_vol_file_roundtrip, read by both
    packages' loaders."""
    from mitsuba_path_guiding_tpu.scene.volume import load_vol as j_load_vol

    data = np.random.RandomState(0).rand(5, 6, 7).astype(np.float32)
    path = str(tmp_path / "grid.vol")
    tvol.save_vol(path, data, (-1, -2, -3), (1, 2, 3))
    got, aabb = tvol.load_vol(path)
    np.testing.assert_array_equal(got, data)
    np.testing.assert_allclose(aabb, [[-1, -2, -3], [1, 2, 3]])
    jgot, jaabb = j_load_vol(path)
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_array_equal(aabb, jaabb)


def test_hgrid_assembly():
    """Twin of tests/test_medium.py::test_hgrid_assembly."""
    b = np.ones((4, 4, 4), np.float32)
    spec = {"type": "hgridvolume", "block_res": 4,
            "blocks": [{"offset": (0, 0, 0), "data": b * 1.0},
                       {"offset": (1, 1, 1), "data": b * 2.0}],
            "bounds": ((0, 0, 0), (1, 1, 1))}
    grid, aabb = tvol.load_volume_spec(spec)
    assert grid.shape == (8, 8, 8)
    assert grid[0, 0, 0] == 1.0 and grid[7, 7, 7] == 2.0 and grid[0, 7, 7] == 0.0
    assert aabb.shape == (2, 3)


def test_volume_scenes_compile_equal_to_reference(tmp_path):
    """volumetric_box, heterogeneous_box and a grid from a .vol file: the
    medium equal to the JAX build array for array; an OpenVDB volume
    raises, naming the loaders' ROADMAP item."""
    for name in ("volumetric_box", "heterogeneous_box"):
        jm = j_build_scene(getattr(jscenes, name)()).medium
        tm = build_scene(getattr(tscenes, name)(), device="cpu").medium
        for f in jm._fields:
            a, b = getattr(jm, f), getattr(tm, f)
            if a is None or isinstance(a, (bool, int)):
                assert a == b, (name, f)
            else:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{name} {f}")
    path = str(tmp_path / "g.vol")
    tvol.save_vol(path, _cloud_spec(res=8)[1].astype(np.float32), (-1, 0, -1), (1, 2, 1))
    spec = {"sigma_s": [0.5] * 3, "sigma_a": [0.1] * 3, "scale": 2.0,
            "density": {"type": "gridvolume", "filename": path}}
    _, tm, conv = _media(spec)
    np.testing.assert_array_equal(tm.world_to_grid.numpy(), conv.world_to_grid.numpy())
    np.testing.assert_array_equal(tm.majorant.numpy(), conv.majorant.numpy())
    # an OpenVDB file is read (tests/test_torch_loaders.py); a missing one
    # raises as the reference's does
    missing = {"sigma_s": [1.0] * 3, "density": {"type": "vdbvolume", "filename": "x.vdb"}}
    with pytest.raises(FileNotFoundError, match="x.vdb"):
        _t_medium(missing)
    with pytest.raises(FileNotFoundError, match="x.vdb"):
        jvolume.load_volume_spec(missing["density"])
    for bad in ({"phase": "mixture", "phase_components": []},
                {"phase": "mixture", "phase_components": [{"type": "kkay"}]},
                {"phase": "mixture", "phase_components": ["hg"], "phase_weights": [-1.0]}):
        with pytest.raises(ValueError):
            _t_medium({"sigma_s": [1.0] * 3, **bad})


# ---------------------------------------------------------------------------
# guided distance sampling
# ---------------------------------------------------------------------------

def _toy_grids():
    """The JAX test's toy grid (flux rising with the cell index), in both
    packages."""
    g = j_make_grid(jnp.zeros(3), jnp.ones(3), res=4, n_lobes=4)
    c = g.s_w.shape[0]
    g = g._replace(s_w=jnp.tile(jnp.arange(c, dtype=jnp.float32)[:, None] / c, (1, 4)),
                   s_count=jnp.ones((c,)))
    return g, port_grid(g)


def test_distance_weights_match_reference():
    """guided_distance_weights, the heterogeneous variant, piecewise_pdf
    and piecewise_sample on 4096 numpy-made rays (rtol 1e-5 on >= 99% of
    lanes)."""
    jg, tg = _toy_grids()
    rs = np.random.RandomState(6)
    o = rs.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    d = _dirs(rs, N)
    t1 = rs.uniform(0.0, 1.5, N).astype(np.float32)
    sig = rs.uniform(0.2, 3.0, N).astype(np.float32)
    u = rs.rand(N).astype(np.float32)
    fj, ft = jdist.cell_flux(jg), tdist.cell_flux(tg)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    wj, dtj, totj = jdist.guided_distance_weights(jg, fj, jnp.asarray(o), jnp.asarray(d),
                                                  jnp.asarray(t1), jnp.asarray(sig))
    wt, dtt, tott = tdist.guided_distance_weights(tg, ft, t(o), t(d), t(t1), t(sig))
    assert frac_close(wt.numpy().T, np.asarray(wj).T, rtol=1e-5) >= 0.99
    assert frac_close(tott.numpy(), np.asarray(totj), rtol=1e-5) >= 0.99
    sj = np.asarray(jdist.piecewise_sample(wj, dtj, totj, jnp.asarray(u)))
    st = tdist.piecewise_sample(wt, dtt, tott, t(u)).numpy()
    assert frac_close(st, sj, rtol=1e-5) >= 0.99
    pj = np.asarray(jdist.piecewise_pdf(wj, dtj, totj, jnp.asarray(sj)))
    pt = tdist.piecewise_pdf(wt, dtt, tott, t(sj)).numpy()
    assert frac_close(pt, pj, rtol=1e-5) >= 0.99 and (pt > 0).mean() > 0.5
    spec, _ = _cloud_spec(res=12)
    jm, tm, _ = _media(spec)
    hj = jdist.guided_distance_weights_hetero(jg, fj, jm, jnp.asarray(o), jnp.asarray(d),
                                              jnp.asarray(t1))
    ht = tdist.guided_distance_weights_hetero(tg, ft, tm, t(o), t(d), t(t1))
    for a, b in zip(ht, hj):
        a, b = a.numpy(), np.asarray(b)
        assert frac_close(a.T if a.ndim > 1 else a, b.T if b.ndim > 1 else b, rtol=1e-5) >= 0.99


def test_piecewise_pdf_normalizes():
    """Twin of tests/test_guided_distance.py::test_piecewise_pdf_normalizes."""
    _, g = _toy_grids()
    flux = tdist.cell_flux(g)
    n = 64
    w, dt, tot = tdist.guided_distance_weights(
        g, flux, torch.tensor([[0.1, 0.5, 0.5]]).expand(n, 3),
        torch.tensor([[1.0, 0.0, 0.0]]).expand(n, 3), torch.full((n,), 0.8),
        torch.full((n,), 1.3))
    assert w.shape == (tdist.N_SEGMENTS, n)
    ts = (torch.arange(tdist.N_SEGMENTS) + 0.5)[:, None] * dt[None, :]
    pdf_mid = torch.stack([tdist.piecewise_pdf(w, dt, tot, ts[i])
                           for i in range(tdist.N_SEGMENTS)])
    np.testing.assert_allclose(torch.sum(pdf_mid * dt[None, :], dim=0).numpy(), 1.0, rtol=1e-5)


def test_piecewise_sample_matches_pdf():
    """Twin of tests/test_guided_distance.py::test_piecewise_sample_matches_pdf."""
    _, g = _toy_grids()
    flux = tdist.cell_flux(g)
    m = 200_000
    w, dt, tot = tdist.guided_distance_weights(
        g, flux, torch.tensor([[0.05, 0.52, 0.51]]).expand(m, 3),
        torch.tensor([[1.0, 0.0, 0.0]]).expand(m, 3), torch.full((m,), 0.9),
        torch.full((m,), 2.0))
    u = trng.uniform(trng.base_key(0), m)
    ts = tdist.piecewise_sample(w, dt, tot, u).numpy()
    dt0 = float(dt[0])
    hist, edges = np.histogram(ts, bins=tdist.N_SEGMENTS, range=(0.0, tdist.N_SEGMENTS * dt0))
    emp = hist / m / dt0
    mid = torch.from_numpy((0.5 * (edges[:-1] + edges[1:])).astype(np.float32))
    ana = np.array([float(tdist.piecewise_pdf(w[:, :1], dt[:1], tot[:1], x[None]))
                    for x in mid])
    mask = ana > 0.05 * ana.max()
    np.testing.assert_allclose(emp[mask], ana[mask], rtol=0.05)


def test_hetero_estimator_expectations():
    """Twin of tests/test_guided_distance.py::test_hetero_estimator_expectations:
    the guided grid-medium collision estimator against the delta tracker
    for both event classes."""
    scene = build_scene(tscenes.heterogeneous_box(sigma_s=0.9, sigma_a=0.1, res=16), device="cpu")
    med = scene.medium
    n = 120_000
    o = torch.tensor([[0.0, 1.0, -1.8]]).expand(n, 3)
    dv = np.array([0.05, 0.02, 1.0])
    d = torch.from_numpy((dv / np.linalg.norm(dv)).astype(np.float32))[None].expand(n, 3)
    t_surf = torch.full((n,), 3.6)
    rk = trng.ray_keys(trng.base_key(0), torch.zeros(n, dtype=torch.int64), torch.arange(n))
    _, is_m, w_ff = tmed.sample_free_flight(med, o, d, t_surf, tmed._track_keys(rk, 0, 31))
    est_trk = float(torch.mean(torch.where(is_m[..., None], w_ff, 0.0)[:, 0]))
    g = make_grid(scene.aabb_min, scene.aabb_max, res=4, n_lobes=4)
    flux = torch.ones((g.s_w.shape[0],))
    w_seg, dt_seg, tot, tr_end = tdist.guided_distance_weights_hetero(g, flux, med, o, d, t_surf)
    u1 = trng.uniform(trng.base_key(1), n)
    u2 = trng.uniform(trng.base_key(2), n)
    p_surf = torch.clamp(tr_end, 0.05, 0.95)
    go_surf = u2 < p_surf
    t_g = tdist.piecewise_sample(w_seg, dt_seg, tot, u1)
    pdf_c = tdist.piecewise_pdf(w_seg, dt_seg, tot, t_g)
    tr_hat = tmed.transmittance_ratio(med, o, d, torch.where(go_surf, t_surf, t_g),
                                      tmed._track_keys(rk, 0, 77))
    ss = tmed.density_at(med, o + t_g[:, None] * d)[:, None] * med.sigma_s
    w_med = ss * tr_hat / torch.clamp_min(((1 - p_surf) * pdf_c)[..., None], 1e-30)
    est_g = float(torch.mean(torch.where(~go_surf[..., None], w_med, 0.0)[:, 0]))
    np.testing.assert_allclose(est_g, est_trk, rtol=0.03)
    est_srf = float(torch.mean(torch.where(go_surf[..., None], tr_hat / p_surf[..., None],
                                           0.0)[:, 0]))
    tr_ref = float(torch.mean(tmed.transmittance_ratio(med, o, d, t_surf,
                                                       tmed._track_keys(rk, 0, 99))[:, 0]))
    np.testing.assert_allclose(est_srf, tr_ref, rtol=0.03)
    assert math.isfinite(est_g)
