"""The port's coat, rough coat and Hanrahan-Krueger slab, and its sun and
sky, against the JAX package on the CPU: the coat transmittance tables
bit-equal; eval, pdf, sample and albedo of COATING (smooth and rough) and
HK on 4096 lanes of numpy-made directions and uniforms, with the rows and
coat tables the two scene compilers build (rtol 1e-5 on >= 99.9% of lanes
for eval/pdf, >= 99% for sample, where a lobe pick near its threshold may
differ by an ulp); the port's own chi-square tests and twins of the JAX
package's coating and HK checks (tests/test_bsdf.py, the rough coat's
closed form of tests/test_approx_bounds.py); the sky images and sun
irradiance equal to the JAX package's, array for array, and twins of
tests/test_sunsky.py; ``trace`` of a coated Cornell box and of the
sunsky plane against JAX's on the same keys; the data files the port
copied equal the JAX package's byte for byte; and no module of the port
imports JAX or the JAX package."""
import ast
import hashlib
import pathlib
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.core.math import fresnel_dielectric
from mitsuba_path_guiding_torch.integrators.path import trace
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.models import bsdf
from mitsuba_path_guiding_torch.models import microfacet_tables as tmt
from mitsuba_path_guiding_torch.models import sunsky as tsun
from mitsuba_path_guiding_torch.models.emitter import kinds_present
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.types import BSDFType
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models import bsdf as jbsdf
from mitsuba_path_guiding_tpu.models import microfacet_tables as jmt
from mitsuba_path_guiding_tpu.models import sunsky as jsun
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from test_torch_bsdf_families import _desc, _row, _unit, _wi, make_mats, mats_from_rows, run_chi2
from test_torch_shading_path import _tallbox, _wave
from torch_port_parity import frac_close, t

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = 4096

FAMILIES = {
    "coating": {"type": "coating", "thickness": 0.5, "sigma_a": [0.3, 0.1, 0.05],
                "bsdf": {"type": "diffuse", "reflectance": [0.8, 0.6, 0.4]}},
    "roughcoating": {"type": "roughcoating", "alpha": 0.3, "int_ior": 1.6,
                     "bsdf": {"type": "roughconductor", "material": "Cu", "alpha": 0.3}},
    "hk": {"type": "hk", "sigma_s": [1.0, 0.8, 0.6], "sigma_a": [0.05, 0.1, 0.2], "g": 0.3},
    "hk_sigma_t": {"type": "hk", "sigma_t": 2.0, "albedo": [0.9, 0.7, 0.5], "thickness": 0.4},
}


# ---------------------------------------------------------------------------
# the coat transmittance table and the families on 4096 lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,eta", [(0.0, 1.5), (1e-3, 1.33), (0.1, 1.5), (0.35, 1.6)])
def test_coat_transmittance_table_equals_jax(alpha, eta):
    got = tmt.coat_transmittance_table(alpha, eta)
    assert got.shape == (tmt.N_COS,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jmt.coat_transmittance_table(alpha, eta))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def lanes(request):
    desc = _desc(FAMILIES[request.param])
    mats = build_scene(desc, device="cpu").mats
    jmats = j_build_scene(desc).mats
    rs = np.random.default_rng(zlib.crc32(request.param.encode()))
    mid = rs.integers(0, mats.packed.shape[0], N).astype(np.int32)
    wi = _unit(rs, N)
    wi[: N * 3 // 4, 2] = np.abs(wi[: N * 3 // 4, 2])  # a quarter from below
    wo = _unit(rs, N)
    # a third of the lanes near the mirror direction, a third near the
    # straight-through one
    k = N // 3
    wo[:k] = wi[:k] * np.float32([-1, -1, 1]) + rs.normal(0, 0.05, (k, 3))
    wo[k:2 * k] = -wi[k:2 * k] + rs.normal(0, 0.05, (k, 3))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u = rs.random((N, 3)).astype(np.float32)
    types = bsdf.types_present(mats)
    assert types == jbsdf.types_present(jmats)
    return request.param, mats, jmats, mid, wi, wo.astype(np.float32), u, types


def test_coat_rows_and_tables_match(lanes):
    name, mats, jmats, *_ = lanes
    np.testing.assert_array_equal(mats.packed.numpy(), np.asarray(jmats.packed))
    np.testing.assert_array_equal(mats.coat_trans.numpy(), np.asarray(jmats.coat_trans))
    coat = mats.type.numpy() == BSDFType.COATING
    assert coat.any() == name.endswith("coating")
    assert (mats.coat_trans.numpy()[coat][:, 1:] > 0).all()  # 0 at grazing, cos 0


def test_coat_eval_pdf_matches(lanes):
    """rtol 1e-5 on >= 99.9% of lanes, but HK's eval on >= 99.5%: its
    transmission term divides exp(-tau/|cos_i|) - exp(-tau/|cos_o|) by
    |cos_i| - |cos_o|, which near the straight-through direction (a third
    of the lanes) turns the last-bit differences of two exp
    implementations into up to 4e-4 relative; rtol 1e-3 on >= 99.9%."""
    name, mats, jmats, mid, wi, wo, _, types = lanes
    f, pdf = bsdf.eval_pdf(mats, torch.from_numpy(mid), torch.from_numpy(wi),
                           torch.from_numpy(wo), types=types)
    fj, pdfj = jbsdf.eval_pdf(jmats, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(wo),
                              types=types)
    assert float(np.asarray(pdfj).max()) > 0.0
    bar = 0.995 if name.startswith("hk") else 0.999
    assert frac_close(f.numpy(), np.asarray(fj), rtol=1e-5) >= bar, name
    assert frac_close(f.numpy(), np.asarray(fj), rtol=1e-3) >= 0.999, name
    assert frac_close(pdf.numpy(), np.asarray(pdfj), rtol=1e-5) >= 0.999, name


def test_coat_sample_matches(lanes):
    name, mats, jmats, mid, wi, _, u, types = lanes
    s = bsdf.sample(mats, torch.from_numpy(mid), torch.from_numpy(wi), torch.from_numpy(u),
                    types=types)
    sj = jbsdf.sample(jmats, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(u), types=types)
    for a, b in zip(s, sj):
        assert frac_close(a.numpy(), np.asarray(b), rtol=1e-5) >= 0.99, name
    assert (s.pdf.numpy() > 0).mean() > 0.3


def test_coat_albedo_matches(lanes):
    _, mats, jmats, mid, *_, types = lanes
    np.testing.assert_array_equal(
        bsdf.albedo(mats, torch.from_numpy(mid), types=types).numpy(),
        np.asarray(jbsdf.albedo(jmats, jnp.asarray(mid))))


# ---------------------------------------------------------------------------
# twins of the JAX package's coating and HK checks (row fixtures without a
# coat table, as the JAX tests build them: the smooth 1 - F transmittance)
# ---------------------------------------------------------------------------

def _coating_mats(thickness=0.5, sigma_a=(0.2, 0.1, 0.05), eta=1.5, alpha=0.1):
    return mats_from_rows([
        _row(BSDFType.COATING, sigma_a, (1, 1, 1), eta, 0.0, alpha, sub_a=1, weight=thickness),
        _row(BSDFType.DIFFUSE, (0.8, 0.6, 0.4), (1, 1, 1), 1.5, 0.0, 0.1),
    ])


def _hk_mats(sigma_s=(1.0, 0.8, 0.6), sigma_a=(0.05, 0.1, 0.2), thickness=1.0, g=0.3):
    return mats_from_rows([_row(BSDFType.HK, sigma_s, (1, 1, 1), g, sigma_a, 0.1,
                                weight=thickness)])


CHI2_CASES = [
    ("coating_25", lambda: _coating_mats(), 25),
    ("coating_60", lambda: _coating_mats(), 60),
    ("roughcoating_25", lambda: _coating_mats(alpha=0.3), 25),
    ("roughcoating_60", lambda: _coating_mats(alpha=0.3), 60),
    ("hk_30", lambda: _hk_mats(), 30),
    ("hk_65", lambda: _hk_mats(), 65),
]


@pytest.mark.parametrize("name,make,theta", CHI2_CASES, ids=[c[0] for c in CHI2_CASES])
def test_coat_chi2(name, make, theta):
    passed, msg = run_chi2(make(), theta, seed=zlib.crc32(name.encode()) % (2**31))
    assert passed, f"{name}: {msg}"


def _sample_and_eval(mats, theta, seed, n=4096):
    types = bsdf.types_present(mats)
    mid = torch.zeros((n,), dtype=torch.int32)
    wi = _wi(np.rad2deg(theta), n)
    u = torch.from_numpy(np.random.default_rng(seed).random((n, 3)).astype(np.float32))
    bs = bsdf.sample(mats, mid, wi, u, types=types)
    f, pdf = bsdf.eval_pdf(mats, mid, wi, bs.wo, types=types)
    ok = (~bs.is_delta & (bs.pdf > 1e-3) & (bs.weight.amax(dim=-1) > 0) & (pdf > 1e-3)).numpy()
    return bs.weight.numpy(), f.numpy(), pdf.numpy(), ok


@pytest.mark.parametrize("mats,theta", [
    (lambda: _coating_mats(thickness=0.5, sigma_a=(0.3, 0.1, 0.05)), 0.7),
    (lambda: _hk_mats(g=0.0), 0.8),
], ids=["coating", "hk"])
def test_coat_weight_is_eval_over_pdf(mats, theta):
    """A smooth sample's weight is eval / pdf (rtol 5e-3, atol 5e-4)."""
    w, f, pdf, ok = _sample_and_eval(mats(), theta, seed=12)
    assert ok.sum() > len(ok) // 4
    np.testing.assert_allclose(w[ok], f[ok] / pdf[ok][:, None], rtol=5e-3, atol=5e-4)


def test_roughcoating_weight_consistency():
    """The rough coat's weights are the whole coat's eval / pdf where the
    outcome is smooth: the median ratio within 35% of 1, as in the JAX
    package's test."""
    w, f, pdf, ok = _sample_and_eval(_coating_mats(alpha=0.35), 0.8, seed=21)
    assert ok.sum() > len(ok) // 4
    ratio = w[ok] / np.maximum(f[ok] / pdf[ok][:, None], 1e-9)
    np.testing.assert_allclose(np.median(ratio, axis=0), 1.0, rtol=0.35)


def _mean_weight(mats, n=50_000):
    wi = torch.tensor([0.3, 0.1, 0.945]).expand(n, 3)
    wi = wi / torch.linalg.vector_norm(wi, dim=-1, keepdim=True)
    u = torch.from_numpy(np.random.default_rng(4).random((n, 3)).astype(np.float32))
    bs = bsdf.sample(mats, torch.zeros((n,), dtype=torch.int32), wi, u,
                     types=bsdf.types_present(mats))
    return float(bs.weight.mean())


def test_coating_limits():
    """A clear coat of eta ~ 1 is its nested diffuse (within 2%); a thick
    absorbing layer darkens more than a thin one."""
    m_plain = _mean_weight(make_mats(BSDFType.DIFFUSE, refl=(0.8, 0.6, 0.4)))
    m_clear = _mean_weight(_coating_mats(thickness=0.0, sigma_a=(0, 0, 0), eta=1.0 + 1e-4))
    assert abs(m_clear - m_plain) / m_plain < 0.02, (m_clear, m_plain)
    thin = _mean_weight(_coating_mats(thickness=0.5, sigma_a=(0.5,) * 3))
    thick = _mean_weight(_coating_mats(thickness=4.0, sigma_a=(0.5,) * 3))
    assert thick < thin < m_plain


def test_roughcoating_ggx_lobe_visible_to_eval():
    """Near the mirror direction a rough coat's eval holds its GGX lobe:
    more than twice a smooth coat's (whose reflection is a delta)."""
    n = 8
    wi = torch.tensor([np.sin(0.6), 0.0, np.cos(0.6)], dtype=torch.float32).expand(n, 3)
    wo = torch.tensor([-np.sin(0.6), 0.0, np.cos(0.6)], dtype=torch.float32).expand(n, 3)
    mid = torch.zeros((n,), dtype=torch.int32)
    rough = _coating_mats(alpha=0.2)
    smooth = _coating_mats(alpha=0.0)
    f_r, pdf_r = bsdf.eval_pdf(rough, mid, wi, wo, types=bsdf.types_present(rough))
    f_s, _ = bsdf.eval_pdf(smooth, mid, wi, wo, types=bsdf.types_present(smooth))
    assert float(f_r.max()) > 2.0 * float(f_s.max())
    assert float(pdf_r[0]) > 0.0


def test_hk_delta_transmission():
    """A thin clear slab is mostly the attenuated straight-through delta;
    a thick one almost never."""
    n = 50_000
    wi = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    mid = torch.zeros((n,), dtype=torch.int32)
    u = torch.from_numpy(np.random.default_rng(6).random((n, 3)).astype(np.float32))
    thin = bsdf.sample(_hk_mats(sigma_s=(0.1,) * 3, sigma_a=(0.01,) * 3, thickness=0.1), mid,
                       wi, u, types=(BSDFType.HK,))
    assert float(thin.is_delta.float().mean()) > 0.95
    wo_d = thin.wo.numpy()[thin.is_delta.numpy()]
    np.testing.assert_allclose(wo_d, np.broadcast_to([0.0, 0.0, -1.0], wo_d.shape), atol=1e-6)
    thick = bsdf.sample(_hk_mats(sigma_s=(3.0,) * 3, sigma_a=(1.0,) * 3, thickness=2.0), mid,
                        wi, u, types=(BSDFType.HK,))
    assert float(thick.is_delta.float().mean()) < 0.05


def _oracle_roughcoating(wi, wo, alpha, eta, kd):
    """The rough coat over a diffuse kd in numpy (roughcoating.cpp's eval,
    no absorption), as tests/test_approx_bounds.py writes it."""
    out = np.zeros(3)
    if wi[2] * wo[2] > 0:
        h = (wi + wo) / np.linalg.norm(wi + wo) * np.sign(wo[2])
        D = tmt._ggx_d(h[2], alpha)
        F = tmt.fresnel_dielectric(abs(np.dot(wi, h)), eta)
        G = tmt._smith_g1(wi[2], alpha) * tmt._smith_g1(wo[2], alpha)
        out = out + F * D * G / (4.0 * abs(wi[2]))
    Ti = tmt.rough_transmittance(abs(wi[2]), alpha, eta)
    To = tmt.rough_transmittance(abs(wo[2]), alpha, eta)
    return out * wo[2] + kd / np.pi * Ti * To / (eta * eta) * wo[2]


def test_roughcoating_eval_matches_closed_form():
    """A compiled rough coat (alpha 0.25, eta 1.5, no absorption) over a
    diffuse row against the closed form on 32 direction pairs: at most
    10% apart, 4% at the median (the 16-entry table's interpolation and
    the quadrature's resolution), the JAX package's bars."""
    alpha, eta, kd = 0.25, 1.5, np.array([0.6, 0.4, 0.3])
    desc = {"shapes": [{"type": "rectangle", "bsdf": {
        "type": "roughcoating", "alpha": alpha, "int_ior": eta, "ext_ior": 1.0,
        "thickness": 0.0, "bsdf": {"type": "diffuse", "reflectance": list(kd)}}}],
        "emitters": [{"type": "constant"}]}
    mats = build_scene(desc, device="cpu").mats
    mid = int(np.flatnonzero(mats.type.numpy() == BSDFType.COATING)[0])
    pairs = [(ti, to, ph) for ti in (15, 40, 65, 80) for to in (10, 35, 60, 78)
             for ph in (0.3, 2.1)]
    wi = np.array([[np.sin(np.radians(a)), 0.0, np.cos(np.radians(a))] for a, _, _ in pairs])
    wo = np.array([[np.sin(np.radians(b)) * np.cos(p), np.sin(np.radians(b)) * np.sin(p),
                    np.cos(np.radians(b))] for _, b, p in pairs])
    f, _ = bsdf.eval_pdf(mats, torch.full((len(pairs),), mid, dtype=torch.int32),
                         torch.from_numpy(wi.astype(np.float32)),
                         torch.from_numpy(wo.astype(np.float32)),
                         types=bsdf.types_present(mats))
    errs = []
    for k in range(len(pairs)):
        ref = _oracle_roughcoating(wi[k], wo[k], alpha, eta, kd)
        errs.append(np.abs(f.numpy()[k] - ref).max() / max(ref.max(), 1e-6))
    assert max(errs) < 0.10 and np.median(errs) < 0.04, (max(errs), np.median(errs))


def test_coat_reflectance_is_fresnel():
    """The smooth coat picks its delta mirror with probability R12 = F(cos)."""
    n = 100_000
    theta = 1.1
    mats = _coating_mats(alpha=0.0)
    wi = torch.tensor([np.sin(theta), 0.0, np.cos(theta)], dtype=torch.float32).expand(n, 3)
    u = torch.from_numpy(np.random.default_rng(9).random((n, 3)).astype(np.float32))
    bs = bsdf.sample(mats, torch.zeros((n,), dtype=torch.int32), wi, u,
                     types=bsdf.types_present(mats))
    R = float(fresnel_dielectric(torch.tensor(np.cos(theta), dtype=torch.float32),
                                 torch.tensor(1.5)))
    assert abs(float(bs.is_delta.float().mean()) - R) < 0.005


# ---------------------------------------------------------------------------
# sun and sky
# ---------------------------------------------------------------------------

def test_sky_images_equal_jax():
    for elev, azim, turb in ((35.0, 40.0, 3.0), (8.0, 180.0, 7.0), (70.0, -60.0, 2.0)):
        sd = tsun.sun_direction_from_angles(elev, azim)
        np.testing.assert_array_equal(sd, jsun.sun_direction_from_angles(elev, azim))
        for fn in ("preetham_sky_image", "hosek_sky_image"):
            got = getattr(tsun, fn)(sd, turb, resolution=32, scale=1.3)
            np.testing.assert_array_equal(got, getattr(jsun, fn)(sd, turb, resolution=32,
                                                                 scale=1.3))
        np.testing.assert_array_equal(tsun.preetham_sun_irradiance(sd, turb, scale=0.7),
                                      jsun.preetham_sun_irradiance(sd, turb, scale=0.7))


def _brightest_direction(img):
    H, W = img.shape[:2]
    iy, ix = np.unravel_index(np.argmax(img.mean(-1)), img.shape[:2])
    th = (iy + 0.5) / H * np.pi
    ph = ((ix + 0.5) / W - 0.5) * 2 * np.pi
    return np.array([np.sin(th) * np.sin(ph), np.cos(th), -np.sin(th) * np.cos(ph)])


@pytest.mark.parametrize("model,near", [("preetham", 0.95), ("hosek", 0.85)])
def test_sky_image_properties(model, near):
    """Finite and non-negative, brightest near the sun, and a hazier sky
    has a different max/mean; the Hosek zenith away from the sun is blue."""
    fn = getattr(tsun, f"{model}_sky_image")
    sd = tsun.sun_direction_from_angles(35.0, 40.0)
    img = fn(sd, turbidity=3.0, resolution=64)
    assert img.shape == (64, 128, 3)
    assert np.isfinite(img).all() and (img >= 0).all()
    assert _brightest_direction(img) @ sd > near
    lum = img.mean(-1)
    lum7 = fn(sd, turbidity=7.0, resolution=64).mean(-1)
    if model == "preetham":
        assert lum7.max() / lum7.mean() < lum.max() / lum.mean()
    else:
        assert lum7.max() / lum7.mean() > lum.max() / lum.mean()
        zen = img[2, 3 * 128 // 4]
        assert zen[2] > zen[0]


def test_sun_irradiance_behavior():
    hi = tsun.preetham_sun_irradiance(tsun.sun_direction_from_angles(60.0), 2.0)
    lo = tsun.preetham_sun_irradiance(tsun.sun_direction_from_angles(5.0), 2.0)
    assert (hi > lo).all()
    assert (tsun.preetham_sun_irradiance(tsun.sun_direction_from_angles(60.0), 8.0) < hi).all()
    assert (tsun.preetham_sun_irradiance(-tsun.sun_direction_from_angles(30.0), 3.0) == 0).all()
    assert lo[0] / max(lo[2], 1e-9) > hi[0] / max(hi[2], 1e-9)


def sunsky_scene(etype):
    """The plane of the JAX package's tests/test_sunsky.py under one
    emitter (azimuth 180 puts the sun on the camera's side)."""
    return {"sensor": {"type": "perspective", "fov": 60.0},
            "shapes": [{"type": "rectangle", "bsdf": {"type": "diffuse"}}],
            "emitters": [{"type": etype, "elevation": 35.0, "azimuth": 180.0,
                          "turbidity": 3.0}]}


@pytest.mark.parametrize("etype", ["sky", "sun", "sunsky"])
def test_sunsky_scene_renders(etype):
    img = render(build_scene(sunsky_scene(etype), device="cpu"),
                 RenderConfig(width=16, height=16, spp=4, max_depth=3)).numpy()
    assert np.isfinite(img).all() and img.mean() > 0, etype


# ---------------------------------------------------------------------------
# traces against the JAX package, from the same keys (a 32x32 wave)
# ---------------------------------------------------------------------------

def _coated_cornell(mod):
    sc = _tallbox(mod, {"type": "roughcoating", "alpha": 0.1,
                        "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.6, 0.5]}})
    sc["shapes"][6]["bsdf"] = {"type": "hk", "sigma_s": [1.0, 0.8, 0.6],
                               "sigma_a": [0.05, 0.1, 0.2], "g": 0.3}
    sc["shapes"][3]["bsdf"] = {"type": "coating", "sigma_a": [0.2, 0.4, 0.4],
                               "bsdf": {"type": "diffuse", "reflectance": [0.63, 0.065, 0.05]}}
    return sc


@pytest.mark.parametrize("name,make", [("coated_cornell", _coated_cornell),
                                       ("sunsky", lambda m: sunsky_scene("sunsky"))])
def test_trace_matches_reference(name, make):
    """L within rtol 1e-4 on >= 99% of lanes (XLA contracts multiply-adds
    on the CPU, and a contraction can move a path)."""
    jscene = j_build_scene(make(jscenes))
    scene = build_scene(make(tscenes), device="cpu")
    o, d, kj = _wave(jscene)
    types, kinds = bsdf.types_present(scene.mats), kinds_present(scene.emitters)
    Lj, auxj, _ = j_trace(jscene, o, d, kj, max_depth=6, rr_depth=3, use_bvh=False,
                          em_kinds=kinds, mat_types=types)
    Lt, auxt, _ = trace(scene, t(o), t(d), t(kj), max_depth=6, rr_depth=3, em_kinds=kinds,
                        mat_types=types)
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0.0
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99, name
    assert (auxt.n_bounces.numpy() == np.asarray(auxj.n_bounces)).mean() >= 0.99
    assert frac_close(auxt.albedo.numpy(), np.asarray(auxj.albedo), rtol=1e-6) >= 0.99


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["hosek_rgb.npz", "sobol_joekuo.npz"])
def test_data_files_are_byte_copies(name):
    def sha(p):
        return hashlib.sha256(p.read_bytes()).hexdigest()

    assert sha(ROOT / "mitsuba_path_guiding_torch" / "data" / name) == sha(
        ROOT / "mitsuba_path_guiding_tpu" / "data" / name)


def test_port_reads_its_own_data(monkeypatch):
    from mitsuba_path_guiding_torch.core import qmc

    opened = []
    real = np.load
    monkeypatch.setattr(np, "load", lambda p, *a, **k: opened.append(p) or real(p, *a, **k))
    monkeypatch.setattr(qmc, "_TABLE", {})
    monkeypatch.setattr(tsun, "_HOSEK_CACHE", {})
    qmc.sobol_direction_numbers(4)
    tsun._hosek_tables()
    got = sorted(pathlib.Path(p).resolve().relative_to(ROOT).as_posix() for p in opened)
    assert got == ["mitsuba_path_guiding_torch/data/hosek_rgb.npz",
                   "mitsuba_path_guiding_torch/data/sobol_joekuo.npz"]


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package at any depth of its AST (a function's imports included)."""
    files = sorted((ROOT / "mitsuba_path_guiding_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 40
    # the volume slice's, the chain and photon integrators', the scene
    # files', the multi-GPU, irradiance-cache and subsurface modules and the
    # spherical harmonics, spectral, manifold, motion and animation modules
    # are among them
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for mod in ("integrators/volpath.py", "models/medium.py", "models/phase.py",
                "guiding/distance.py", "scene/volume.py", "scene/builder.py", "render.py",
                "models/texture.py", "models/cloth.py", "film/bitmap.py", "film/denoise.py",
                "film/neural_denoise.py", "util.py", "integrators/pssmlt.py",
                "integrators/erpt.py", "integrators/mlt.py", "integrators/sppm.py",
                "integrators/photonmapper.py", "integrators/volphoton.py",
                "scene/xml_loader.py", "scene/vdb.py", "scene/collada.py",
                "utils/checkpoint.py", "utils/preview.py", "utils/logger.py",
                "film/tiled.py", "parallel/mesh.py", "integrators/irrcache.py",
                "integrators/subsurface.py", "core/sh.py", "core/spectral.py",
                "integrators/manifold.py", "integrators/spectral.py", "integrators/motion.py",
                "scene/animation.py"):
        assert f"mitsuba_path_guiding_torch/{mod}" in names, mod
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for nm in names:
                assert nm.split(".")[0] not in ("jax", "jaxlib", "mitsuba_path_guiding_tpu"), \
                    (path, nm)
