"""The port's camera, sampler and film vocabulary against the JAX package
on the CPU: every function of ``core/qmc.py`` bit-equal on 65536 indices;
``camera_jitter`` (through ``wave_keys_and_jitter``) bit-equal for every
sampler; ``generate_rays`` of every sensor kind and ``connect_to_sensor``
within 1e-5; each reconstruction filter's weights within 1e-6 and
``splat`` within 1e-5; the image readers and writers; and ``trace`` with
explicit uniforms.  tests/test_torch_camera_render.py renders with them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.core import qmc, rng
from mitsuba_path_guiding_torch.film import film as tfilm
from mitsuba_path_guiding_torch.film.exr import read_exr
from mitsuba_path_guiding_torch.film.rfilter import FILTERS, get_filter
from mitsuba_path_guiding_torch.integrators.path import trace
from mitsuba_path_guiding_torch.integrators.render import (
    SAMPLERS,
    RenderConfig,
    wave_keys_and_jitter,
)
from mitsuba_path_guiding_torch.models.bsdf import types_present
from mitsuba_path_guiding_torch.models.emitter import kinds_present
from mitsuba_path_guiding_torch.models.sensor import connect_to_sensor, generate_rays
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_tpu.core import qmc as jqmc
from mitsuba_path_guiding_tpu.core import rng as jrng
from mitsuba_path_guiding_tpu.film import film as jfilm
from mitsuba_path_guiding_tpu.film import rfilter as jrfilter
from mitsuba_path_guiding_tpu.integrators import render as jrender
from mitsuba_path_guiding_tpu.integrators.path import trace as j_trace
from mitsuba_path_guiding_tpu.models import sensor as jsensor
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, t

N = 65536
RS = np.random.default_rng(1234)
IDX = np.arange(N, dtype=np.uint32)
IDX_WIDE = RS.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
U2 = RS.random((N, 2)).astype(np.float32)


def _bits_equal(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype == np.uint32:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.astype(np.float32).view(np.int32))


# ---------------------------------------------------------------------------
# core/qmc.py, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("base", jqmc.PRIMES)
def test_radical_inverse_bits(base):
    for idx in (IDX, IDX_WIDE):
        _bits_equal(qmc.radical_inverse(base, t(idx)), jqmc.radical_inverse(base, jnp.asarray(idx)))


def test_halton_and_rotation_bits():
    for dim in (0, 1, 5, 13):
        _bits_equal(qmc.halton_point(dim, t(IDX)), jqmc.halton_point(dim, jnp.asarray(IDX)))
    _bits_equal(qmc.cp_rotate(t(U2), t(U2[::-1].copy())),
                jqmc.cp_rotate(jnp.asarray(U2), jnp.asarray(U2[::-1])))
    _bits_equal(qmc.halton_2d(t(IDX), t(U2)), jqmc.halton_2d(jnp.asarray(IDX), jnp.asarray(U2)))


@pytest.mark.parametrize("n_total", [1, 16, 50])
def test_stratified_bits(n_total):
    sidx = (IDX % 4099).astype(np.int32)
    _bits_equal(qmc.stratified_2d(t(sidx), n_total, t(U2)),
                jqmc.stratified_2d(jnp.asarray(sidx), n_total, jnp.asarray(U2)))


def test_sobol_bits():
    sv = qmc.sobol_direction_numbers(32)
    jsv = jqmc.sobol_direction_numbers(32)
    _bits_equal(sv, jsv)
    _bits_equal(qmc.sobol_bits(t(IDX), sv), jqmc.sobol_bits(jnp.asarray(IDX), jsv))
    shift = RS.integers(0, 2**30, (N, 32), dtype=np.uint64).astype(np.uint32)
    _bits_equal(qmc.sobol_point(t(IDX_WIDE), sv, t(shift)),
                jqmc.sobol_point(jnp.asarray(IDX_WIDE), jsv, jnp.asarray(shift)))
    _bits_equal(qmc.sobol_point(t(IDX), sv), jqmc.sobol_point(jnp.asarray(IDX), jsv))
    _bits_equal(qmc._shift_bits(t(U2)), jqmc._shift_bits(jnp.asarray(U2)))
    _bits_equal(qmc.sobol_2d(t(IDX), t(U2)), jqmc.sobol_2d(jnp.asarray(IDX), jnp.asarray(U2)))


def test_owen_scramble_bits():
    seeds = RS.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    _bits_equal(qmc._reverse_bits32(t(IDX_WIDE)), jqmc._reverse_bits32(jnp.asarray(IDX_WIDE)))
    _bits_equal(qmc.owen_scramble(t(IDX_WIDE), t(seeds)),
                jqmc.owen_scramble(jnp.asarray(IDX_WIDE), jnp.asarray(seeds)))


@pytest.mark.parametrize("max_depth,n_qmc", [(5, 2), (4, 6)])
def test_sobol_path_uniforms_bits(max_depth, n_qmc):
    pix = (IDX % 1024).astype(np.int32)
    sidx = (IDX // 1024).astype(np.int32)
    pk = jrng.pixel_keys(jrng.base_key(3), jnp.asarray(pix))
    rk = jax.vmap(jax.random.fold_in)(pk, jnp.asarray(sidx))
    want = jqmc.sobol_path_uniforms(rk, pk, jnp.asarray(sidx), max_depth, n_qmc)
    tpk = rng.pixel_keys(rng.base_key(3), t(pix, torch.int64))
    trk = rng.fold_in(tpk, t(sidx, torch.int64))
    got = qmc.sobol_path_uniforms(trk, tpk, t(sidx, torch.int64), max_depth, n_qmc)
    assert got.shape == (9 * max_depth, N)
    _bits_equal(got, want)


# ---------------------------------------------------------------------------
# camera jitter of every sampler, through wave_keys_and_jitter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", SAMPLERS)
def test_camera_jitter_bits(sampler):
    assert set(SAMPLERS) == {"independent", "stratified", "halton", "hammersley", "sobol",
                             "ldsampler"}
    pix = (IDX[:16384] % 4096).astype(np.int32)
    sidx = (IDX[:16384] // 4096 + 7).astype(np.int32)
    cfg = dict(width=64, height=64, spp=12, seed=5, sampler=sampler)
    _, _, ju_cam, ju_pos = jrender.wave_keys_and_jitter(jrender.RenderConfig(**cfg),
                                                        jnp.asarray(pix), jnp.asarray(sidx))
    _, _, u_cam, u_pos = wave_keys_and_jitter(RenderConfig(**cfg), t(pix, torch.int64),
                                              t(sidx, torch.int64))
    _bits_equal(u_cam, ju_cam)
    _bits_equal(u_pos, ju_pos)


def test_unknown_sampler_is_refused():
    with pytest.raises(ValueError, match="sampler"):
        wave_keys_and_jitter(RenderConfig(sampler="sobbol"), torch.arange(4), torch.zeros(4))


# ---------------------------------------------------------------------------
# sensors
# ---------------------------------------------------------------------------

SENSORS = {
    "perspective": {},
    "thinlens": {"type": "thinlens", "aperture_radius": 0.1, "focus_distance": 3.7},
    "perspective_rdist": {"type": "perspective_rdist", "kc": [0.1, 0.02]},
    "orthographic": {"type": "orthographic", "ortho_width": 1.2},
    "spherical": {"type": "spherical"},
    "telecentric": {"type": "telecentric", "ortho_width": 1.0, "aperture_radius": 0.05,
                    "focus_distance": 3.7},
    "irradiancemeter": {"type": "irradiancemeter"},
    "radiancemeter": {"type": "radiancemeter"},
    "fluencemeter": {"type": "fluencemeter"},
}


def _cornell_with(mod, sensor):
    sc = mod.cornell_box()
    sc["sensor"] = {**sc["sensor"], **sensor}
    return sc


@pytest.mark.parametrize("name", list(SENSORS))
def test_generate_rays_per_sensor(name):
    """Origins and directions within 1e-5 (XLA's matmul against the port's
    fixed-order sums), film positions bit-equal, with and without the
    aperture's uniforms."""
    jsc = j_build_scene(_cornell_with(jscenes, SENSORS[name]))
    sc = build_scene(_cornell_with(tscenes, SENSORS[name]), device="cpu")
    assert sc.sensor.kind == int(jsc.sensor.kind)
    w, h = 48, 32
    pix = np.arange(w * h, dtype=np.int32)
    u = RS.random((w * h, 4)).astype(np.float32)
    for u_lens in (None, u[:, 2:4]):
        want = jsensor.generate_rays(jsc.sensor, w, h, jnp.asarray(pix), jnp.asarray(u[:, :2]),
                                     None if u_lens is None else jnp.asarray(u_lens),
                                     kind=int(jsc.sensor.kind))
        got = generate_rays(sc.sensor, w, h, t(pix, torch.int64), t(u[:, :2]),
                            None if u_lens is None else t(u_lens), kind=sc.sensor.kind)
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
        _bits_equal(got[2], want[2])


def test_connect_to_sensor():
    jsc = j_build_scene(jscenes.cornell_box())
    sc = build_scene(tscenes.cornell_box(), device="cpu")
    p = (RS.random((4096, 3)) * [2.0, 2.0, 4.0] - [1.0, 0.0, 3.0]).astype(np.float32)
    want = jsensor.connect_to_sensor(jsc.sensor, 64, 48, jnp.asarray(p))
    got = connect_to_sensor(sc.sensor, 64, 48, t(p))
    valid = np.asarray(want[4])
    assert 0.2 < valid.mean() < 1.0
    np.testing.assert_array_equal(got[4].numpy(), valid)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# reconstruction filters and the film
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jrfilter.FILTERS))
def test_filter_weights_and_splat(name):
    assert set(FILTERS) == set(jrfilter.FILTERS)
    fn, radius = get_filter(name)
    jfn, jradius = jrfilter.get_filter(name)
    assert radius == jradius
    x = np.linspace(-3.5, 3.5, 2001, dtype=np.float32)
    np.testing.assert_allclose(fn(t(x)).numpy(), np.asarray(jfn(jnp.asarray(x))), rtol=1e-6,
                               atol=1e-6)
    w, h, n = 12, 9, 3000
    xy = (RS.random((n, 2)) * [w, h]).astype(np.float32)
    vals = RS.random((n, 3)).astype(np.float32)
    sw = RS.random(n).astype(np.float32)
    for weight in (None, sw):
        want = jfilm.splat(jnp.zeros((w * h, 4)), jnp.asarray(xy), jnp.asarray(vals), w, h,
                           name, None if weight is None else jnp.asarray(weight))
        got = tfilm.splat(torch.zeros((w * h, 4)), t(xy), t(vals), w, h, name,
                          None if weight is None else t(weight))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_image_io(tmp_path):
    img = RS.random((8, 12, 3)).astype(np.float32)
    tfilm.write_image(str(tmp_path / "x.pfm"), torch.from_numpy(img))
    np.testing.assert_array_equal(tfilm.read_pfm(str(tmp_path / "x.pfm")), img)
    np.testing.assert_array_equal(jfilm.read_pfm(str(tmp_path / "x.pfm")), img)
    tfilm.write_image(str(tmp_path / "t.png"), img)
    jfilm.write_png(str(tmp_path / "j.png"), img)
    import zlib

    def pixels(p):
        data = p.read_bytes()
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        start = data.index(b"IDAT") + 4
        return np.frombuffer(zlib.decompress(data[start:data.index(b"IEND") - 8]), np.uint8)

    got, want = pixels(tmp_path / "t.png"), pixels(tmp_path / "j.png")
    assert got.shape == want.shape == (8 * (1 + 12 * 3),)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    chans = {"albedo.R": img[..., 0], "depth": img[..., 1]}
    tfilm.write_exr_channels(str(tmp_path / "a.exr"), chans)
    back, _ = read_exr(str(tmp_path / "a.exr"))
    for k, v in chans.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)


def test_splat_raw():
    w, h, n = 10, 7, 4000
    xy = (RS.random((n, 2)) * [w + 2, h + 2] - 1).astype(np.float32)
    vals = RS.random((n, 3)).astype(np.float32)
    want = jfilm.splat_raw(jnp.zeros((w * h, 3)), jnp.asarray(xy), jnp.asarray(vals), w, h)
    got = tfilm.splat_raw(torch.zeros((w * h, 3)), t(xy), t(vals), w, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# explicit uniforms
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cornell():
    return j_build_scene(jscenes.cornell_box()), build_scene(tscenes.cornell_box(), device="cpu")


def test_trace_with_explicit_uniforms(cornell):
    """A 32x32 wave traced with the Sobol' path uniforms (2 of 4 bounces)
    by both packages: L within rtol 1e-4 on >= 99% of lanes; the uniforms
    decide the paths (other uniforms, another image)."""
    jsc, sc = cornell
    n = 1024
    pix = np.arange(n, dtype=np.int32)
    sidx = np.full(n, 3, np.int32)
    pk = jrng.pixel_keys(jrng.base_key(0), jnp.asarray(pix))
    rk = jax.vmap(jax.random.fold_in)(pk, jnp.asarray(sidx))
    u = jrng.event_uniform(rk, jrng.TAG_CAMERA, 2)
    o, d, _ = jsensor.generate_rays(jsc.sensor, 32, 32, jnp.asarray(pix), u)
    uni = jqmc.sobol_path_uniforms(rk, pk, jnp.asarray(sidx), 4, 2)
    types, kinds = types_present(sc.mats), kinds_present(sc.emitters)
    Lj, _, _ = j_trace(jsc, o, d, rk, uniforms=uni, max_depth=4, rr_depth=3, use_bvh=False,
                       em_kinds=kinds, mat_types=types)
    Lt, _, _ = trace(sc, t(o), t(d), t(rk), uniforms=t(uni), max_depth=4, rr_depth=3,
                     em_kinds=kinds, mat_types=types)
    L0, _, _ = trace(sc, t(o), t(d), t(rk), max_depth=4, rr_depth=3, em_kinds=kinds,
                     mat_types=types)
    Lj = np.asarray(Lj)
    assert Lj.mean() > 0
    assert frac_close(Lt.numpy(), Lj, rtol=1e-4) >= 0.99
    assert frac_close(L0.numpy(), Lj, rtol=1e-4) < 0.9
    with pytest.raises(ValueError, match="uniforms"):
        trace(sc, t(o), t(d), t(rk), uniforms=t(uni)[:9], max_depth=4)
