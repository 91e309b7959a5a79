"""The port's woven cloth against the JAX package on the CPU: the weave
parser and the compiled tile bit for bit (the build-time Monte Carlo
normalization included), the record decode, the per-lane specular
integrand in torch, CLOTH eval, pdf and sample on 4096 lanes from the same
seeded inputs (with and without yarn records), a chi-square test of the
cloth sampler with the port's core/chi2.py; twins of the JAX package's
tests/test_cloth.py and test_irawan_oracle.py; and the four open
departures of the reference's cloth from the published model, each
pinned as reproduced by the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.core import chi2
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.models import bsdf
from mitsuba_path_guiding_torch.models.cloth import (
    PLAIN_WEAVE,
    compile_cloth,
    decode_record,
    parse_weave,
    segment_lookup,
)
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.transforms import look_at
from mitsuba_path_guiding_torch.scene.types import BSDFType, Materials
from mitsuba_path_guiding_tpu.models import bsdf as jbsdf
from mitsuba_path_guiding_tpu.models import cloth as jcloth
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from test_irawan_oracle import IrawanOracle, _fetch_records
from torch_port_parity import frac_close

N = 4096
CLOTH = (int(BSDFType.CLOTH),)
STAPLE = PLAIN_WEAVE.replace(
    "type = warp, umax = 35,", "type = warp, psi = 40, umax = 35,").replace(
    "type = weft, umax = 35,", "type = weft, psi = 40, umax = 35,")
# a denser weave with a third yarn: pattern 3x2, unequal widths and kd/ks
TWILL = """
weave {
    name = "twill3", alpha = 0.02, beta = 2.0, ss = 0.3, hWidth = 0.4,
    tileWidth = 3, tileHeight = 2,
    pattern { 1, 2, 3, 3, 1, 2 },
    yarn { type = warp, umax = 30, kappa = -0.4, width = 0.9, length = 1.2,
           centerU = 0.5, centerV = 0.4, kd = {0.6, 0.2, 0.1}, ks = {0.3, 0.2, 0.1} },
    yarn { type = weft, umax = 25, kappa = 0.8, width = 1.0, length = 1.1,
           centerU = 0.4, centerV = 0.5, kd = {0.1, 0.3, 0.6}, ks = {0.1, 0.1, 0.2} },
    yarn { type = warp, umax = 20, kappa = 0.0, width = 0.8, length = 1.0,
           centerU = 0.5, centerV = 0.5, kd = {0.5, 0.5, 0.5}, ks = {0.2, 0.2, 0.2} }
}
"""
WEAVES = {"plain": PLAIN_WEAVE, "staple": STAPLE, "twill": TWILL}


def _desc(spec):
    return {"sensor": {"type": "orthographic", "to_world": look_at([0, 0, -2], [0, 0, 0])},
            "shapes": [{"type": "rectangle", "bsdf": spec}],
            "emitters": [{"type": "point", "position": [1.0, 1.0, -2.0],
                          "intensity": [6.0] * 3}]}


@pytest.fixture(scope="module")
def scenes():
    cache = {}

    def get(name):
        if name not in cache:
            spec = {"type": "irawan", "weave": WEAVES[name], "repeatU": 4, "repeatV": 4}
            js, ts = j_build_scene(_desc(spec)), build_scene(_desc(spec), device="cpu")
            cc = jcloth.compile_cloth(jcloth.parse_weave(WEAVES[name]))
            mid = int(np.where(np.asarray(js.mats.packed)[:, 0] == CLOTH[0])[0][0])
            cache[name] = (js, ts, cc, mid)
        return cache[name]
    return get


@pytest.mark.parametrize("name", list(WEAVES))
def test_parse_weave_equals_reference(name):
    got, want = parse_weave(WEAVES[name]), jcloth.parse_weave(WEAVES[name])
    assert got.keys() == want.keys()
    for k in got:
        if k != "yarns":
            assert got[k] == want[k], k
    for ya, yb in zip(got["yarns"], want["yarns"]):
        for k in ya:
            np.testing.assert_array_equal(ya[k], yb[k], err_msg=k)


@pytest.mark.parametrize("name", list(WEAVES))
def test_compile_cloth_bit_equal(name):
    """The tile, the records and the scalars, the Monte Carlo norm, the
    Ward fallback's alpha and energy scale included, equal to the
    reference's bit for bit."""
    got = compile_cloth(parse_weave(WEAVES[name]), res=16)
    want = jcloth.compile_cloth(jcloth.parse_weave(WEAVES[name]), res=16)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["norm"] > 0.0 and got["fb_scale"] > 0.0


def test_decode_and_segment_lookup_equal():
    wp = parse_weave(TWILL)
    rng = np.random.default_rng(1)
    uu, vv = rng.random(N), rng.random(N)
    for a, b in zip(segment_lookup(wp, uu, vv), jcloth.segment_lookup(wp, uu, vv)):
        np.testing.assert_array_equal(a, b)
    rec = compile_cloth(wp, res=8)["aux_img"].reshape(-1, 3)
    for a, b in zip(decode_record(rec), jcloth.decode_record(rec)):
        np.testing.assert_array_equal(a, b)
    # the torch decode, as the tracer runs it, equals the numpy one
    for a, b in zip(decode_record(torch.from_numpy(rec)), decode_record(rec)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)


def _cos_hemi(rng, n):
    return IrawanOracle._cos_hemi(rng.random((n, 2)))


def _inputs(cc, seed, n=N):
    rng = np.random.default_rng(seed)
    wi = _cos_hemi(rng, n) * np.where(rng.random((n, 1)) < 0.1, -1.0, 1.0)  # some from below
    wo = _cos_hemi(rng, n)
    uv = rng.random((n, 2))
    rec, px, py = _fetch_records(cc["aux_img"], uv)
    kd = cc["kd_img"][py, px]
    return wi.astype(np.float32), wo.astype(np.float32), rec, kd.astype(np.float32)


def _aux(rec):
    weft, u, v, ks = decode_record(rec.astype(np.float32))
    return weft, u.astype(np.float32), v.astype(np.float32), ks.astype(np.float32)


@pytest.mark.parametrize("name", list(WEAVES))
def test_cloth_spec_raw_matches_reference(scenes, name):
    """The torch integrand against JAX's at float32 on 4096 lanes: the
    band gates are thresholds, and torch's and XLA's sin/atan differ in
    the last bits, so >= 99% of lanes within rtol 1e-4."""
    _, _, cc, _ = scenes(name)
    wi, wo, rec, _ = _inputs(cc, 5)
    weft, u, v, _ = _aux(rec)
    sc = [cc[k] for k in ("alpha", "beta", "ss", "psi", "umax", "kappa", "w", "l", "h_width",
                          "area_warp", "area_weft")]
    want = np.asarray(jbsdf.cloth_spec_raw(jnp.asarray(wi), jnp.asarray(wo), jnp.asarray(weft),
                                           jnp.asarray(u), jnp.asarray(v), *sc))
    T = torch.from_numpy
    got = bsdf.cloth_spec_raw(T(wi), T(wo), T(weft), T(u), T(v),
                              *(torch.full((N,), x, dtype=torch.float32) for x in sc))
    assert want.mean() > 0.0
    assert frac_close(got.numpy(), want, rtol=1e-4, atol=1e-5) >= 0.99


def _jax_tex(kd, aux):
    return ((jnp.asarray(kd), jnp.ones((kd.shape[0],), bool)),
            tuple(jnp.asarray(a) for a in aux))


def _port_tex(kd, aux):
    return ((torch.from_numpy(kd), torch.ones((kd.shape[0],), dtype=torch.bool)),
            tuple(torch.from_numpy(np.asarray(a)) for a in aux))


@pytest.mark.parametrize("records", [True, False], ids=["records", "fallback"])
@pytest.mark.parametrize("name", list(WEAVES))
def test_cloth_eval_pdf_sample_match_reference(scenes, name, records):
    """CLOTH eval, pdf and sample on 4096 lanes of the compiled scene's
    row, with the kd texture and the yarn records as the tracer fetches
    them, or without records (the Ward fallback of trace_vol)."""
    js, ts, cc, mid = scenes(name)
    wi, wo, rec, kd = _inputs(cc, 7)
    aux = _aux(rec)
    jtex, jaux = _jax_tex(kd, aux)
    ttex, taux = _port_tex(kd, aux)
    if not records:
        jaux = taux = None
    u3 = np.random.default_rng(8).random((N, 3)).astype(np.float32)
    jm = jnp.full((N,), mid, jnp.int32)
    tm = torch.full((N,), mid, dtype=torch.int32)
    fj, pj = jbsdf.eval_pdf(js.mats, jm, jnp.asarray(wi), jnp.asarray(wo), types=CLOTH,
                            tex=jtex, cloth_aux=jaux)
    ft, pt = bsdf.eval_pdf(ts.mats, tm, torch.from_numpy(wi), torch.from_numpy(wo), types=CLOTH,
                           tex=ttex, cloth_aux=taux)
    assert np.asarray(fj).mean() > 0.0
    assert frac_close(ft.numpy(), np.asarray(fj), rtol=1e-4, atol=1e-6) >= 0.99
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-7)
    bj = jbsdf.sample(js.mats, jm, jnp.asarray(wi), jnp.asarray(u3), types=CLOTH, tex=jtex,
                      cloth_aux=jaux)
    bt = bsdf.sample(ts.mats, tm, torch.from_numpy(wi), torch.from_numpy(u3), types=CLOTH,
                     tex=ttex, cloth_aux=taux)
    # the cosine warp's sqrt and sin/cos round apart on a lane or two
    assert frac_close(bt.wo.numpy(), np.asarray(bj.wo), rtol=1e-5, atol=1e-6) >= 0.999
    assert frac_close(bt.pdf.numpy(), np.asarray(bj.pdf), rtol=1e-5, atol=1e-6) >= 0.999
    assert frac_close(bt.weight.numpy(), np.asarray(bj.weight), rtol=1e-4, atol=1e-6) >= 0.99
    assert not bool(bt.is_delta.any())


def test_cloth_sampler_chi2(scenes):
    """The cosine-hemisphere sampler of a CLOTH row against its pdf."""
    _, ts, cc, mid = scenes("plain")
    n = 150_000
    theta = np.deg2rad(40.0)
    wi = torch.tensor([np.sin(theta), 0.0, np.cos(theta)], dtype=torch.float32).expand(n, 3)
    u3 = torch.from_numpy(np.random.default_rng(21).random((n, 3)).astype(np.float32))
    rec = torch.from_numpy(cc["aux_img"][5, 7]).expand(n, 3)
    aux = decode_record(rec)
    bs = bsdf.sample(ts.mats, torch.full((n,), mid, dtype=torch.int32), wi, u3, types=CLOTH,
                     cloth_aux=aux)

    def pdf_fn(dirs):
        m = dirs.shape[0]
        _, pdf = bsdf.eval_pdf(ts.mats, torch.full((m,), mid, dtype=torch.int32), wi[:m],
                               torch.from_numpy(np.asarray(dirs, np.float32)), types=CLOTH,
                               cloth_aux=tuple(a[:m] for a in aux))
        return pdf.numpy()

    keep = bs.pdf > 0.0
    passed, _, msg = chi2.chi2_test_sphere(bs.wo[keep].numpy(), pdf_fn, sample_count=n,
                                           significance=0.0025)
    assert passed, msg


# --------------------------------------------------- twins of the JAX tests

def test_parse_weave_format():
    wp = parse_weave(PLAIN_WEAVE)
    assert wp["tileWidth"] == 2 and wp["tileHeight"] == 2 and wp["pattern"] == [1, 2, 2, 1]
    warp, weft = wp["yarns"]
    assert warp["type"] == 0 and weft["type"] == 1
    np.testing.assert_allclose(warp["umax"], np.deg2rad(35.0))
    np.testing.assert_allclose(warp["ks"], [0.2, 0.19, 0.18])
    np.testing.assert_allclose(weft["ks"], [0.18, 0.18, 0.2])


def test_parse_weave_dollar_params():
    text = PLAIN_WEAVE.replace("kd = {0.45, 0.4, 0.36}", "kd = $warp_kd").replace(
        "umax = 35, kappa = 0.5, width = 1, length = 1,\n           centerU = 0.5, centerV = 0.5,"
        "\n           kd = {0.4, 0.36, 0.45}",
        "umax = $umax, kappa = 0.5, width = 1, length = 1,\n           centerU = 0.5, "
        "centerV = 0.5,\n           kd = {0.4, 0.36, 0.45}")
    wp = parse_weave(text, {"warp_kd": [0.7, 0.1, 0.2], "umax": 20.0})
    np.testing.assert_allclose(wp["yarns"][0]["kd"], [0.7, 0.1, 0.2])
    np.testing.assert_allclose(wp["yarns"][1]["umax"], np.deg2rad(20.0))
    with pytest.raises(ValueError, match="warp_kd"):
        parse_weave(text, {"umax": 20.0})


def test_yarn_record_roundtrip():
    wp = parse_weave(PLAIN_WEAVE)
    cc = compile_cloth(wp, res=16)
    H, W = cc["aux_img"].shape[:2]
    uv = np.random.default_rng(2).random((N, 2))
    rec, px, py = _fetch_records(cc["aux_img"], uv)
    weft_d, u_d, v_d, ks_d = decode_record(rec)
    weft_e, u_e, v_e, _ = segment_lookup(wp, (px + 0.5) / W, 1.0 - (py + 0.5) / H)
    assert (weft_d == weft_e).all()
    np.testing.assert_allclose(u_d, u_e, atol=1e-5)
    np.testing.assert_allclose(v_d, v_e, atol=1e-5)
    assert np.isfinite(ks_d).all() and (ks_d > 0).all()


def test_cloth_renders_with_weave_structure():
    img = render(build_scene(_desc({"type": "irawan", "repeatU": 4, "repeatV": 4}), device="cpu"),
                 RenderConfig(width=32, height=32, spp=16, max_depth=2)).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01
    assert img[8:-8, 8:-8].mean(-1).std() > 0.01


@pytest.fixture(scope="module")
def oracle():
    wp = parse_weave(PLAIN_WEAVE)
    return wp, IrawanOracle(wp, n_norm=20000), compile_cloth(wp)


def test_cloth_spec_matches_oracle_pointwise(oracle):
    """The port's torch integrand at exact yarn records against the
    independent oracle of tests/test_irawan_oracle.py."""
    wp, orc, _ = oracle
    rng = np.random.default_rng(5)
    n = 20000
    wi, wo, uv = _cos_hemi(rng, n), _cos_hemi(rng, n), rng.random((n, 2))
    raw_o = orc._specular_raw(uv, wi, wo)
    weft, u, v, _ = segment_lookup(wp, uv[:, 0], uv[:, 1])
    mean = lambda k: float(np.mean([y[k] for y in wp["yarns"]]))  # noqa: E731
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)  # noqa: E731
    sc = [wp["alpha"], wp["beta"], wp["ss"], mean("psi"), mean("umax"), mean("kappa"),
          mean("width"), mean("length"), wp["hWidth"], 2.0, 2.0]
    raw_m = bsdf.cloth_spec_raw(T(wi), T(wo), torch.from_numpy(weft), T(u), T(v),
                                *(torch.full((n,), x, dtype=torch.float64) for x in sc)).numpy()
    assert np.abs(raw_m - raw_o).mean() / max(raw_o.mean(), 1e-9) < 1e-3


def test_compiled_cloth_error_bound_vs_oracle(oracle):
    """Twin of test_irawan_oracle.py's bound, through the port's compile
    and the numpy path of its integrand: tile-averaged < 2%, pointwise
    < 3%, energy < 2% off the oracle."""
    wp, orc, cc = oracle
    rng = np.random.default_rng(3)
    NW, NO, NU = 8, 160, 384
    wis, wos, uvs = _cos_hemi(rng, NW), _cos_hemi(rng, NO), rng.random((NU, 2))
    WI = np.repeat(np.repeat(wis[:, None, None, :], NO, 1), NU, 2).reshape(-1, 3)
    WO = np.repeat(np.repeat(wos[None, :, None, :], NW, 0), NU, 2).reshape(-1, 3)
    UV = np.tile(uvs[None, None, :, :], (NW, NO, 1, 1)).reshape(-1, 2)
    ref = orc.eval(UV, WI, WO).reshape(NW, NO, NU, 3)
    rec, px, py = _fetch_records(cc["aux_img"], UV)
    weft, u, v, ks_s = decode_record(rec)
    raw = bsdf.cloth_spec_raw(WI, WO, weft, u, v, *(cc[k] for k in (
        "alpha", "beta", "ss", "psi", "umax", "kappa", "w", "l", "h_width", "area_warp",
        "area_weft")), xp=np)
    f = cc["kd_img"][py, px] / np.pi + cc["mean_ks"][None, :] * (raw * cc["norm"] * ks_s)[:, None]
    up = (WI[:, 2] > 0) & (WO[:, 2] > 0)
    apx = np.where(up[:, None], f * np.maximum(WO[:, 2], 0.0)[:, None], 0.0).reshape(ref.shape)
    e_avg = np.abs(apx.mean(2) - ref.mean(2)).mean() / np.abs(ref.mean(2)).mean()
    e_pt = np.abs(apx - ref).mean() / np.abs(ref).mean()
    assert e_avg < 0.02 and e_pt < 0.03, (e_avg, e_pt)
    assert abs(apx.mean() - ref.mean()) / ref.mean() < 0.02


def test_compiled_eval_matches_oracle(oracle):
    """The port's CLOTH eval through the compiled scene's row, the kd
    texture and the records fetched as the tracer fetches them, against
    the oracle: pointwise rel-L1 < 4%, the pdf the cosine hemisphere."""
    wp, orc, cc = oracle
    ts = build_scene(_desc({"type": "irawan"}), device="cpu")
    mid = int(np.where(ts.mats.packed[:, 0].numpy() == CLOTH[0])[0][0])
    np.testing.assert_allclose(float(ts.mats.packed[mid, 15]), cc["norm"], rtol=1e-5)
    rng = np.random.default_rng(7)
    wil, wol, uv = _cos_hemi(rng, N), _cos_hemi(rng, N), rng.random((N, 2))
    rec, px, py = _fetch_records(cc["aux_img"], uv)
    tex, aux = _port_tex(cc["kd_img"][py, px].astype(np.float32), _aux(rec))
    f, pdf = bsdf.eval_pdf(ts.mats, torch.full((N,), mid, dtype=torch.int32),
                           torch.from_numpy(wil.astype(np.float32)),
                           torch.from_numpy(wol.astype(np.float32)), types=CLOTH, tex=tex,
                           cloth_aux=aux)
    ref = orc.eval(uv, wil, wol)
    assert np.abs(f.numpy() - ref).mean() / np.abs(ref).mean() < 0.04
    exp_pdf = np.where((wil[:, 2] > 0) & (wol[:, 2] > 0), np.maximum(wol[:, 2], 0.0) / np.pi, 0.0)
    np.testing.assert_allclose(pdf.numpy(), exp_pdf, atol=1e-5)


def test_cloth_sample_weight_consistency(scenes):
    _, ts, cc, mid = scenes("plain")
    wi, _, rec, kd = _inputs(cc, 11, n=2048)
    wi = np.abs(wi)
    tex, aux = _port_tex(kd, _aux(rec))
    m = torch.full((2048,), mid, dtype=torch.int32)
    u3 = torch.from_numpy(np.random.default_rng(12).random((2048, 3)).astype(np.float32))
    bs = bsdf.sample(ts.mats, m, torch.from_numpy(wi), u3, types=CLOTH, tex=tex, cloth_aux=aux)
    f, pdf = bsdf.eval_pdf(ts.mats, m, torch.from_numpy(wi), bs.wo, types=CLOTH, tex=tex,
                           cloth_aux=aux)
    np.testing.assert_allclose(bs.pdf.numpy(), pdf.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose((bs.weight * bs.pdf[:, None]).numpy(), f.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_staple_integrand_matches_oracle():
    wp = parse_weave(STAPLE)
    orc = IrawanOracle(wp, n_norm=20000)
    rng = np.random.default_rng(13)
    n = 20000
    wi, wo, uv = _cos_hemi(rng, n), _cos_hemi(rng, n), rng.random((n, 2))
    raw_o = orc._specular_raw(uv, wi, wo)
    assert raw_o.mean() > 0
    weft, u, v, _ = segment_lookup(wp, uv[:, 0], uv[:, 1])
    y0 = wp["yarns"][0]
    sc = [wp["alpha"], wp["beta"], wp["ss"], y0["psi"], y0["umax"], y0["kappa"], 1.0, 1.0,
          wp["hWidth"], 2.0, 2.0]
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64)  # noqa: E731
    raw_m = bsdf.cloth_spec_raw(T(wi), T(wo), torch.from_numpy(weft), T(u), T(v),
                                *(torch.full((n,), x, dtype=torch.float64) for x in sc)).numpy()
    assert np.abs(raw_m - raw_o).mean() / max(raw_o.mean(), 1e-9) < 1e-3


def test_cloth_fallback_energy(oracle, scenes):
    _, orc, _ = oracle
    _, ts, _, mid = scenes("plain")
    rng = np.random.default_rng(17)
    n = 20000
    wil, wol, uv = _cos_hemi(rng, n), _cos_hemi(rng, n), rng.random((n, 2))
    f, _ = bsdf.eval_pdf(ts.mats, torch.full((n,), mid, dtype=torch.int32),
                         torch.from_numpy(wil.astype(np.float32)),
                         torch.from_numpy(wol.astype(np.float32)), types=CLOTH)
    ref = orc.eval(uv, wil, wol)
    assert abs(float(f.mean()) - ref.mean()) / ref.mean() < 0.08


# ------------------------------------------ the reference's open departures

def _nested_cloth_mats(mod_build, cloth_row):
    """A BLEND row (weight 0.5) over a diffuse row and a CLOTH row: the
    builder refuses a nested irawan, so the table is made by hand."""
    packed = np.zeros((3, 32), np.float32)
    packed[0, 0], packed[0, 16], packed[0, 17], packed[0, 18] = int(BSDFType.BLEND), 1, 2, 0.5
    packed[1, 0], packed[1, 1:4] = int(BSDFType.DIFFUSE), 0.5
    packed[2] = cloth_row
    packed[:, 25:27] = 1.0
    return packed


@pytest.mark.parametrize("finding", ["warp_weft_area_dropped", "nested_cloth_is_black",
                                     "ks_collapses_to_luminance", "yarn_noise_dropped"])
def test_reference_cloth_departures_reproduced(scenes, finding):
    """The reference's four open cloth departures from the published
    model: the port reproduces each one, equal to the JAX package.
    - warp_weft_area_dropped: parse_weave drops warpArea/weftArea, so both
      area factors read (0.5 + 0.5) / 0.5 = 2 whatever the pattern says;
    - nested_cloth_is_black: a CLOTH row nested under BLEND evaluates to
      nothing (the nested rows take the smooth families without CLOTH);
    - ks_collapses_to_luminance: a yarn's ks becomes a luminance scale of
      the pattern's mean ks, clipped at 2;
    - yarn_noise_dropped: period and fineness compile to the same cloth
      as a pattern without them."""
    if finding == "warp_weft_area_dropped":
        text = PLAIN_WEAVE.replace("warpArea = 0.5, weftArea = 0.5",
                                   "warpArea = 0.3, weftArea = 0.7")
        got = compile_cloth(parse_weave(text), res=8)
        want = jcloth.compile_cloth(jcloth.parse_weave(text), res=8)
        assert "warpArea" not in parse_weave(text)
        assert got["area_warp"] == got["area_weft"] == 2.0
        assert (got["area_warp"], got["area_weft"], got["norm"]) == \
            (want["area_warp"], want["area_weft"], want["norm"])
    elif finding == "nested_cloth_is_black":
        js, _, _, mid = scenes("plain")
        packed = _nested_cloth_mats(None, np.asarray(js.mats.packed)[mid])
        types = (int(BSDFType.DIFFUSE), int(BSDFType.BLEND), int(BSDFType.CLOTH))
        rng = np.random.default_rng(3)
        wi, wo = _cos_hemi(rng, 256).astype(np.float32), _cos_hemi(rng, 256).astype(np.float32)
        cols = dict(type=packed[:, 0].astype(np.int32), reflectance=packed[:, 1:4],
                    specular=packed[:, 4:7], eta=packed[:, 7:10], k=packed[:, 10:13],
                    alpha=packed[:, 13], texture_id=packed[:, 14].astype(np.int32))
        tm = Materials(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in cols.items()},
                       packed=torch.from_numpy(packed))
        from mitsuba_path_guiding_tpu.scene.types import Materials as JMaterials

        jm = JMaterials(**{k: jnp.asarray(v) for k, v in cols.items()},
                        packed=jnp.asarray(packed), coat_trans=None)
        f_t, _ = bsdf.eval_pdf(tm, torch.zeros(256, dtype=torch.int32), torch.from_numpy(wi),
                               torch.from_numpy(wo), types=types)
        f_j, _ = jbsdf.eval_pdf(jm, jnp.zeros(256, jnp.int32), jnp.asarray(wi),
                                jnp.asarray(wo), types=types)
        # only the diffuse half of the blend is left: 0.5 * 0.5 / pi * cos
        diffuse_half = 0.25 / np.pi * wo[:, 2:3] * np.ones((1, 3), np.float32)
        np.testing.assert_allclose(f_t.numpy(), diffuse_half, rtol=1e-5)
        np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6, atol=1e-8)
    elif finding == "ks_collapses_to_luminance":
        # yarn 1's ks luminance is 2.9 times the pattern's mean, and red
        text = TWILL.replace("ks = {0.3, 0.2, 0.1}", "ks = {1.5, 0.6, 0.6}").replace(
            "ks = {0.1, 0.1, 0.2}", "ks = {0.01, 0.01, 0.01}").replace(
            "ks = {0.2, 0.2, 0.2}", "ks = {0.01, 0.01, 0.01}")
        got = compile_cloth(parse_weave(text), res=8)
        want = jcloth.compile_cloth(jcloth.parse_weave(text), res=8)
        _, _, _, ks = decode_record(got["aux_img"].reshape(-1, 3))
        assert np.isclose(ks.max(), 2.0)  # 2.93 clipped at 2
        # one specular colour for every yarn: the pattern's mean
        np.testing.assert_allclose(got["mean_ks"], [0.50666667, 0.20666667, 0.20666667],
                                   rtol=1e-6)
        np.testing.assert_array_equal(got["mean_ks"], want["mean_ks"])
        np.testing.assert_array_equal(got["aux_img"], want["aux_img"])
    else:
        text = PLAIN_WEAVE.replace("hWidth = 0.5,", "hWidth = 0.5, period = 3.0, fineness = 2.0,")
        got = compile_cloth(parse_weave(text), res=8)
        plain = compile_cloth(parse_weave(PLAIN_WEAVE), res=8)
        want = jcloth.compile_cloth(jcloth.parse_weave(text), res=8)
        for k in got:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(plain[k]), err_msg=k)
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
