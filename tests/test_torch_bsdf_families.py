"""The port's analytic BSDF families against the JAX package on the CPU:
eval, pdf, sample and albedo of every family this slice ports on 4096
lanes of numpy-made directions and uniforms, with the rows the two scene
compilers build; the port's own chi-square sample/pdf agreement (its copy
of core/chi2.py) for the smooth families; and twins of the JAX package's
blend, mask and thin-dielectric sampling checks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zlib

from mitsuba_path_guiding_torch.core import chi2
from mitsuba_path_guiding_torch.core.math import fresnel_dielectric
from mitsuba_path_guiding_torch.models import bsdf
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.types import BSDFType, Materials
from mitsuba_path_guiding_tpu.models import bsdf as jbsdf
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close

N = 4096
CHI2_N = 150_000

# The GGX and Ward lobes are no sharper than alpha 0.25 here: XLA contracts
# the multiply-adds of its dot products on the CPU, and a sharper lobe near
# its peak amplifies that past rtol 1e-5 (tests/test_torch_bsdf.py holds
# alpha 0.08 to 1e-4)
FAMILIES = {
    "roughdiffuse": {"type": "roughdiffuse", "alpha": 0.5, "reflectance": [0.6, 0.5, 0.4]},
    "conductor": {"type": "conductor", "material": "Au"},
    "dielectric": {"type": "dielectric", "int_ior": 1.5},
    "thindielectric": {"type": "thindielectric", "int_ior": 1.33},
    "roughdielectric": {"type": "roughdielectric", "alpha": 0.3},
    "plastic": {"type": "plastic", "reflectance": [0.5, 0.3, 0.2]},
    "roughplastic": {"type": "roughplastic", "alpha": 0.3, "reflectance": [0.2, 0.4, 0.6]},
    "phong": {"type": "phong", "alpha": 0.2, "reflectance": 0.5, "specular_reflectance": 0.4},
    "ward": {"type": "ward", "alpha_u": 0.25, "alpha_v": 0.4, "reflectance": 0.3,
             "specular_reflectance": 0.6},
    "difftrans": {"type": "difftrans", "reflectance": [0.7, 0.5, 0.3]},
    "null": {"type": "null"},
    "blendbsdf": {"type": "blendbsdf", "weight": 0.4,
                  "bsdfs": [{"type": "diffuse", "reflectance": [0.7, 0.2, 0.2]},
                            {"type": "roughconductor", "material": "Au", "alpha": 0.3}]},
    "mixturebsdf": {"type": "mixturebsdf", "weights": [0.7, 0.3],
                    "bsdfs": [{"type": "roughplastic", "alpha": 0.3},
                              {"type": "dielectric"}]},
    "mask": {"type": "mask", "opacity": 0.3,
             "bsdf": {"type": "roughconductor", "alpha": 0.3}},
}


def _desc(spec):
    return {"shapes": [
        {"type": "rectangle", "bsdf": spec},
        {"type": "rectangle", "bsdf": {"type": "diffuse", "reflectance": [0.7, 0.6, 0.5]},
         "emitter": {"radiance": [1.0, 1.0, 1.0]}},
    ]}


def _unit(rs, n):
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def lanes(request):
    desc = _desc(FAMILIES[request.param])
    mats = build_scene(desc, device="cpu").mats
    jmats = j_build_scene(desc).mats
    rs = np.random.default_rng(zlib.crc32(request.param.encode()))
    m = mats.packed.shape[0]
    mid = rs.integers(0, m, N).astype(np.int32)
    wi = _unit(rs, N)
    wi[: N * 3 // 4, 2] = np.abs(wi[: N * 3 // 4, 2])  # a quarter from below
    wo = _unit(rs, N)
    # a third of the lanes near the mirror direction, a third near the
    # straight-through one, where the glossy and transmissive lobes are
    k = N // 3
    wo[:k] = wi[:k] * np.float32([-1, -1, 1]) + rs.normal(0, 0.05, (k, 3))
    wo[k:2 * k] = -wi[k:2 * k] + rs.normal(0, 0.05, (k, 3))
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u = rs.random((N, 3)).astype(np.float32)
    types = bsdf.types_present(mats)
    assert types == jbsdf.types_present(jmats)
    return request.param, mats, jmats, mid, wi, wo.astype(np.float32), u, types


def test_family_rows_match(lanes):
    _, mats, jmats, *_ = lanes
    np.testing.assert_array_equal(mats.packed.numpy(), np.asarray(jmats.packed))


def test_family_eval_pdf_matches(lanes):
    name, mats, jmats, mid, wi, wo, _, types = lanes
    f, pdf = bsdf.eval_pdf(mats, torch.from_numpy(mid), torch.from_numpy(wi),
                           torch.from_numpy(wo), types=types)
    fj, pdfj = jbsdf.eval_pdf(jmats, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(wo),
                              types=types)
    assert frac_close(f.numpy(), np.asarray(fj), rtol=1e-5) >= 0.999, name
    assert frac_close(pdf.numpy(), np.asarray(pdfj), rtol=1e-5) >= 0.999, name


def test_family_sample_matches(lanes):
    name, mats, jmats, mid, wi, _, u, types = lanes
    s = bsdf.sample(mats, torch.from_numpy(mid), torch.from_numpy(wi), torch.from_numpy(u),
                    types=types)
    sj = jbsdf.sample(jmats, jnp.asarray(mid), jnp.asarray(wi), jnp.asarray(u), types=types)
    # a Fresnel lobe pick near its threshold may differ by an ulp
    for a, b in zip(s, sj):
        assert frac_close(a.numpy(), np.asarray(b), rtol=1e-5) >= 0.99, name
    assert (s.pdf.numpy() > 0).mean() > 0.3


def test_family_albedo_matches(lanes):
    _, mats, jmats, mid, *_ , types = lanes
    np.testing.assert_array_equal(
        bsdf.albedo(mats, torch.from_numpy(mid), types=types).numpy(),
        np.asarray(jbsdf.albedo(jmats, jnp.asarray(mid))))


# ---------------------------------------------------------------------------
# the port's own chi-square tests (JAX tests/test_bsdf.py, the smooth
# families this slice ports)
# ---------------------------------------------------------------------------

def _row(mtype, refl, spec, eta, k, alpha, alpha_v=None, sub_a=-1, sub_b=-1, weight=0.0):
    packed = np.zeros((32,), dtype=np.float32)
    packed[0] = mtype
    packed[1:4] = refl
    packed[4:7] = spec
    packed[7:10] = eta
    packed[10:13] = k
    packed[13] = alpha
    packed[14] = -1
    packed[15] = alpha if alpha_v is None else alpha_v
    packed[16] = sub_a
    packed[17] = sub_b
    packed[18] = weight
    packed[19] = -1
    packed[20] = 1.0
    return packed


def mats_from_rows(rows):
    packed = torch.from_numpy(np.stack(rows).astype(np.float32))
    m = packed.shape[0]
    return Materials(type=packed[:, 0].to(torch.int32), reflectance=packed[:, 1:4],
                     specular=packed[:, 4:7], eta=packed[:, 7:10], k=packed[:, 10:13],
                     alpha=packed[:, 13], texture_id=torch.full((m,), -1, dtype=torch.int32),
                     packed=packed)


def make_mats(mtype, refl=(0.8, 0.6, 0.4), spec=(1.0, 1.0, 1.0), eta=1.5, k=0.0, alpha=0.3,
              alpha_v=None):
    return mats_from_rows([_row(mtype, refl, spec, eta, k, alpha, alpha_v)])


def _blend_mats(weight=0.35):
    """Row 0 blends a diffuse row 1 and a rough-conductor row 2."""
    return mats_from_rows([
        _row(BSDFType.BLEND, 0, 0, 1.5, 0.0, 0.1, sub_a=1, sub_b=2, weight=weight),
        _row(BSDFType.DIFFUSE, (0.8, 0.6, 0.4), 1, 1.5, 0.0, 0.1),
        _row(BSDFType.ROUGH_CONDUCTOR, 0.5, 1, [0.2, 0.9, 1.4], [3.9, 2.4, 2.1], 0.35),
    ])


def _mask_mats(opacity=0.7):
    return mats_from_rows([
        _row(BSDFType.MASK, 0, 0, 1.5, 0.0, 0.1, sub_a=1, weight=opacity),
        _row(BSDFType.DIFFUSE, (0.8, 0.6, 0.4), 1, 1.5, 0.0, 0.1),
    ])


def _wi(theta_deg, n):
    th = np.deg2rad(theta_deg)
    return torch.tensor([np.sin(th), 0.0, np.cos(th)], dtype=torch.float32).expand(n, 3)


def _uniforms(seed, n):
    return torch.from_numpy(np.random.default_rng(seed).random((n, 3)).astype(np.float32))


def run_chi2(mats, theta, seed, significance=0.0025):
    types = bsdf.types_present(mats)
    mid = torch.zeros((CHI2_N,), dtype=torch.int32)
    bs = bsdf.sample(mats, mid, _wi(theta, CHI2_N), _uniforms(seed, CHI2_N), types=types)
    keep = ~bs.is_delta & (bs.pdf > 0.0)  # rejected samples carry no mass

    def pdf_fn(dirs):
        m = dirs.shape[0]
        _, pdf = bsdf.eval_pdf(mats, torch.zeros((m,), dtype=torch.int32), _wi(theta, m),
                               torch.from_numpy(np.asarray(dirs, np.float32)), types=types)
        return pdf.numpy()

    passed, _, msg = chi2.chi2_test_sphere(bs.wo[keep].numpy(), pdf_fn, sample_count=CHI2_N,
                                           significance=significance)
    return passed, msg


CHI2_CASES = [
    ("diffuse_30", lambda: make_mats(BSDFType.DIFFUSE), 30),
    ("diffuse_75", lambda: make_mats(BSDFType.DIFFUSE), 75),
    ("orennayar", lambda: make_mats(BSDFType.ROUGH_DIFFUSE, alpha=0.4), 45),
    ("ggx_smoothish", lambda: make_mats(BSDFType.ROUGH_CONDUCTOR, alpha=0.1, eta=[0.2, 0.9, 1.4],
                                        k=[3.9, 2.4, 2.1]), 30),
    ("ggx_rough", lambda: make_mats(BSDFType.ROUGH_CONDUCTOR, alpha=0.5, eta=[0.2, 0.9, 1.4],
                                    k=[3.9, 2.4, 2.1]), 60),
    ("plastic", lambda: make_mats(BSDFType.PLASTIC), 40),
    ("roughplastic", lambda: make_mats(BSDFType.ROUGH_PLASTIC, alpha=0.3), 40),
    ("phong", lambda: make_mats(BSDFType.PHONG, alpha=0.25), 35),
    ("roughdielectric_out", lambda: make_mats(BSDFType.ROUGH_DIELECTRIC, alpha=0.35), 30),
    ("roughdielectric_grazing", lambda: make_mats(BSDFType.ROUGH_DIELECTRIC, alpha=0.35), 70),
    ("roughdielectric_inside", lambda: make_mats(BSDFType.ROUGH_DIELECTRIC, alpha=0.4), 150),
    ("ward_iso", lambda: make_mats(BSDFType.WARD, refl=(0.3, 0.2, 0.1), spec=(0.6, 0.6, 0.6),
                                   alpha=0.25), 35),
    ("ward_aniso", lambda: make_mats(BSDFType.WARD, refl=(0.2, 0.2, 0.2), spec=(0.7, 0.7, 0.7),
                                     alpha=0.1, alpha_v=0.4), 50),
    ("difftrans", lambda: make_mats(BSDFType.DIFFTRANS, refl=(0.7, 0.5, 0.3)), 30),
    ("difftrans_below", lambda: make_mats(BSDFType.DIFFTRANS, refl=(0.7, 0.5, 0.3)), 140),
    ("blend", lambda: _blend_mats(0.35), 40),
    ("mask", lambda: _mask_mats(0.7), 30),
]


@pytest.mark.parametrize("name,make,theta", CHI2_CASES, ids=[c[0] for c in CHI2_CASES])
def test_family_chi2(name, make, theta):
    # grazing rough glass sits near the significance boundary (f32
    # half-vector math): the reference's lower significance there
    sig = 0.001 if "grazing" in name else 0.0025
    passed, msg = run_chi2(make(), theta, seed=zlib.crc32(name.encode()) % (2**31),
                           significance=sig)
    assert passed, f"{name}: {msg}"


def test_blend_weight_consistency():
    """The sampled weight of a smooth blend sample is eval / pdf."""
    mats = _blend_mats(0.6)
    types = bsdf.types_present(mats)
    n = 4096
    mid = torch.zeros((n,), dtype=torch.int32)
    wi = _wi(np.rad2deg(0.5), n)
    bs = bsdf.sample(mats, mid, wi, _uniforms(8, n), types=types)
    f, pdf = bsdf.eval_pdf(mats, mid, wi, bs.wo, types=types)
    ok = (~bs.is_delta & (bs.pdf > 1e-4) & (bs.weight.amax(dim=-1) > 0)).numpy()
    assert ok.sum() > n // 2
    np.testing.assert_allclose(bs.weight.numpy()[ok], f.numpy()[ok] / pdf.numpy()[ok][:, None],
                               rtol=2e-3, atol=2e-4)


def test_mask_passthrough_fraction():
    """The pass-through lobe: straight through with weight 1, picked with
    probability 1 - opacity."""
    mats = _mask_mats(0.7)
    n = 100_000
    wi = torch.tensor([0.0, 0.6, 0.8]).expand(n, 3)
    bs = bsdf.sample(mats, torch.zeros((n,), dtype=torch.int32), wi, _uniforms(3, n),
                     types=bsdf.types_present(mats))
    is_pass = bs.is_delta.numpy()
    assert abs(is_pass.mean() - 0.3) < 0.01, is_pass.mean()
    np.testing.assert_allclose(bs.wo.numpy()[is_pass], -wi.numpy()[is_pass], atol=1e-6)
    np.testing.assert_allclose(bs.weight.numpy()[is_pass], 1.0, atol=1e-6)


def _slab_walk_reflectance(cos_i, eta, n=400_000, seed=11):
    """Random walk through a two-interface slab: reflect or enter at the
    top face, bounce between the faces (the interior Fresnel R equals the
    exterior one), exit up or down.  The Monte-Carlo total reflectance."""
    R = float(fresnel_dielectric(torch.tensor(cos_i, dtype=torch.float32), torch.tensor(eta)))
    rng = np.random.default_rng(seed)
    up = np.zeros(n, bool)
    alive = np.ones(n, bool)
    inside = np.zeros(n, bool)
    heading_down = np.ones(n, bool)
    for _ in range(64):
        refl = rng.random(n) < R
        newly_in = alive & ~inside & ~refl
        up |= alive & ~inside & refl
        alive &= ~(alive & ~inside & refl)
        inside |= newly_in
        bounce = alive & inside & refl
        exit_ = alive & inside & ~refl & ~newly_in
        up |= exit_ & ~heading_down
        alive &= ~exit_
        heading_down = np.where(bounce, ~heading_down, heading_down)
    return up.mean()


def test_thindielectric_sample_stats():
    """Sampled lobes are the exact mirror and pass-through deltas; the
    reflected share matches R' = 2R/(1+R) and a two-interface slab walk."""
    eta = 1.5
    mats = make_mats(BSDFType.THINDIELECTRIC, eta=eta)
    n = 200_000
    for theta in (0.2, 0.9, 1.35):
        wi = torch.tensor([np.sin(theta), 0.0, np.cos(theta)], dtype=torch.float32).expand(n, 3)
        bs = bsdf.sample(mats, torch.zeros((n,), dtype=torch.int32), wi,
                         _uniforms(int(theta * 100), n), types=bsdf.types_present(mats))
        assert bool(bs.is_delta.all())
        np.testing.assert_allclose(bs.weight.numpy(), 1.0, atol=1e-6)
        wo = bs.wo.numpy()
        is_m = np.abs(wo - [-np.sin(theta), 0.0, np.cos(theta)]).max(-1) < 1e-5
        is_t = np.abs(wo - [-np.sin(theta), 0.0, -np.cos(theta)]).max(-1) < 1e-5
        assert (is_m | is_t).all()
        R = float(fresnel_dielectric(torch.tensor(np.cos(theta), dtype=torch.float32),
                                     torch.tensor(eta)))
        Rp = 2.0 * R / (1.0 + R)
        assert abs(is_m.mean() - Rp) < 0.005, (theta, is_m.mean(), Rp)
        walk = _slab_walk_reflectance(np.cos(theta), eta)
        assert abs(walk - Rp) < 0.005, (theta, walk, Rp)
