"""The port's spherical harmonics (``core/sh.py``) and spectral helpers
(``core/spectral.py``, ``integrators/spectral.py``) against the JAX
package on the CPU.

``eval_basis`` (4 bands, 4096 directions), ``project`` and
``rotation_matrix`` within 1e-6 of the reference; ``sample_sh`` with the
same uniforms: the CDF's cell indices bit-equal (XLA's CPU cumulative sum,
``searchsorted`` to the left), directions and pdf within 1e-6; the four
bars of tests/test_sh.py on the port.  Every function of
``core/spectral.py`` equal to the reference's, the luminance integral
bit for bit; ``_bin_scene``, ``_has_dispersion`` and ``_emitter_bin``
equal on chip_smoke's spectral scenes, single bins and packed triples.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from mitsuba_path_guiding_torch.core import chi2, rng
from mitsuba_path_guiding_torch.core import sh
from mitsuba_path_guiding_torch.core import spectral as S
from mitsuba_path_guiding_torch.integrators import spectral as PS
from mitsuba_path_guiding_torch.scene.transforms import rotate
from mitsuba_path_guiding_tpu.core import sh as jsh
from mitsuba_path_guiding_tpu.core import spectral as JS
from mitsuba_path_guiding_tpu.integrators import spectral as JPS
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from torch_port_parity import assert_tree_equal, t

TOL = 1e-6


def _dirs(n, seed):
    d = np.random.default_rng(seed).standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_eval_basis_matches_jax():
    d = _dirs(4096, 0)
    got = sh.eval_basis(t(d), 4).numpy()
    np.testing.assert_allclose(got, np.asarray(jsh.eval_basis(jnp.asarray(d), 4)),
                               rtol=0, atol=TOL)
    c = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(sh.eval_sh(t(c), t(d)).numpy(),
                               np.asarray(jsh.eval_sh(jnp.asarray(c), jnp.asarray(d))),
                               rtol=0, atol=TOL)


def test_project_and_rotation_match_jax():
    got = sh.project(lambda d: 0.5 + d[..., 0] * d[..., 2] + 0.3 * d[..., 1], 3, device="cpu")
    want = jsh.project(lambda d: 0.5 + d[..., 0] * d[..., 2] + 0.3 * d[..., 1], bands=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    R = np.asarray(rotate([1.0, 0.0, 0.0], 90.0))[:3, :3]
    np.testing.assert_allclose(sh.rotation_matrix(R, 4, device="cpu").numpy(),
                               np.asarray(jsh.rotation_matrix(R, bands=4)), rtol=0, atol=TOL)


def _positive_coeffs():
    return sh.project(lambda d: (d[..., 2] + 1.2) * 0.5, 2, device="cpu")


def test_sample_sh_matches_jax():
    c = _positive_coeffs()
    u = rng.uniform_shape(rng.base_key(3), (20000, 2))
    dirs, pdf = sh.sample_sh(c, u, res=48)
    jdirs, jpdf = jsh.sample_sh(jnp.asarray(c.numpy()), jnp.asarray(u.numpy()), res=48)
    np.testing.assert_allclose(dirs.numpy(), np.asarray(jdirs), rtol=0, atol=TOL)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=TOL, atol=0)
    # the cells: the same pmf through each package's cumulative sum and search
    pmf = np.random.default_rng(4).random(48 * 96).astype(np.float32)
    pmf /= pmf.sum()
    got = torch.searchsorted(rng.cumsum_xla(t(pmf)), u[:, 0].contiguous()).numpy()
    want = np.asarray(jnp.searchsorted(jnp.cumsum(jnp.asarray(pmf)), jnp.asarray(u[:, 0].numpy())))
    np.testing.assert_array_equal(got, want)


def _grid(res):
    th = (np.arange(res) + 0.5) / res * np.pi
    ph = (np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    d = np.stack([np.sin(TH) * np.cos(PH), np.sin(TH) * np.sin(PH), np.cos(TH)], -1)
    return d.reshape(-1, 3).astype(np.float32), ((np.pi / res) ** 2 * np.sin(TH)).reshape(-1)


def test_sh_bars_on_the_port():
    """tests/test_sh.py's four checks: orthonormality (atol 2e-3), the
    projection round trip (5e-3), rotation (2e-2) and sampling's chi^2."""
    d, dA = _grid(96)
    B = sh.eval_basis(t(d), 4).numpy()
    np.testing.assert_allclose((B * dA[:, None]).T @ B, np.eye(16), atol=2e-3)
    fn = lambda v: 0.5 + v[..., 0] * v[..., 2] + 0.3 * v[..., 1]  # noqa: E731
    c = sh.project(fn, 3, device="cpu")
    d48, _ = _grid(48)
    np.testing.assert_allclose(sh.eval_sh(c, t(d48)).numpy(), fn(d48), atol=5e-3)
    c4 = sh.project(lambda v: torch.clamp_min(v[..., 2], 0.0) + 0.2, 4, device="cpu")
    R = np.asarray(rotate([1.0, 0.0, 0.0], 90.0))[:3, :3]
    M = sh.rotation_matrix(R, 4, device="cpu")
    d32, _ = _grid(32)
    np.testing.assert_allclose(sh.eval_sh(M @ c4, t(d32)).numpy(),
                               sh.eval_sh(c4, t((d32 @ R).astype(np.float32))).numpy(), atol=2e-2)
    res = 48
    c2 = _positive_coeffs()
    dirs, _ = sh.sample_sh(c2, rng.uniform_shape(rng.base_key(3), (120_000, 2)), res=res)
    ct = 1.0 - (np.arange(res) + 0.5) * (2.0 / res)
    ph = (np.arange(2 * res) + 0.5) / (2 * res) * 2 * np.pi
    CT, PH = np.meshgrid(ct, ph, indexing="ij")
    ST = np.sqrt(np.maximum(1 - CT * CT, 0.0))
    dg = np.stack([ST * np.cos(PH), ST * np.sin(PH), CT], -1).reshape(-1, 3).astype(np.float32)
    vals = np.maximum(sh.eval_sh(c2, t(dg)).numpy(), 1e-9)
    pmf = (vals / vals.sum()).reshape(res, 2 * res)
    cell_sa = (2.0 / res) * (2 * np.pi / (2 * res))

    def pdf_fn(dd):
        iy = np.clip(((1.0 - dd[:, 2]) / (2.0 / res)).astype(int), 0, res - 1)
        ix = np.clip(((np.arctan2(dd[:, 1], dd[:, 0]) % (2 * np.pi))
                      / (2 * np.pi / (2 * res))).astype(int), 0, 2 * res - 1)
        return pmf[iy, ix] / cell_sa

    passed, _, msg = chi2.chi2_test_sphere(dirs.numpy(), pdf_fn)
    assert passed, msg


def test_spectral_functions_equal_jax(tmp_path):
    assert S._CIE_Y_INT == JS._CIE_Y_INT
    lam = np.linspace(360.0, 760.0, 41)
    for n in (4, 8, 16, 24):
        np.testing.assert_array_equal(S.bin_edges(n), JS.bin_edges(n))
        np.testing.assert_array_equal(S.bin_centers(n), JS.bin_centers(n))
        spec = np.random.default_rng(n).random(n)
        np.testing.assert_array_equal(S.spectrum_to_xyz(spec, n), JS.spectrum_to_xyz(spec, n))
        np.testing.assert_array_equal(S.spectrum_to_rgb(spec, n), JS.spectrum_to_rgb(spec, n))
        rgb = np.array([[0.8, 0.2, 0.1], [0.2, 0.7, 0.3], [0.5, 0.5, 0.5]])
        np.testing.assert_array_equal(S.rgb_to_spectrum(rgb, n), JS.rgb_to_spectrum(rgb, n))
        for temp in (2500.0, 6504.0, 10000.0):
            for norm in (True, False):
                np.testing.assert_array_equal(S.blackbody(temp, n, norm),
                                              JS.blackbody(temp, n, norm))
    np.testing.assert_array_equal(S.cmf_at(lam), JS.cmf_at(lam))
    np.testing.assert_array_equal(S.cauchy_ior(lam), JS.cauchy_ior(lam))
    np.testing.assert_array_equal(S.cauchy_ior(lam, 1.45, 0.01), JS.cauchy_ior(lam, 1.45, 0.01))
    p = tmp_path / "glass.spd"
    p.write_text("# comment\n400 1.52\n500 1.50\n\n700 1.48\n")
    np.testing.assert_array_equal(S.load_spd(str(p), 8), JS.load_spd(str(p), 8))


@pytest.mark.parametrize("name", ["hero", "dispersive", "cornell"])
def test_bin_scene_equals_jax(name):
    from mitsuba_path_guiding_torch.scene import scenes as tscenes

    desc, jdesc = chip_smoke.slice13_descs(tscenes)[name], chip_smoke.slice13_descs(jscenes)[name]
    assert PS._has_dispersion(desc) == JPS._has_dispersion(jdesc) == (name == "dispersive")
    for n_bins in (4, 8):
        lam = S.bin_centers(n_bins)
        for ks in (0, n_bins - 1, (0, 1, 2), (n_bins - 2, n_bins - 1, n_bins - 1)):
            k_mid = ks if np.ndim(ks) == 0 else ks[1]
            assert_tree_equal(PS._bin_scene(desc, float(lam[k_mid]), ks, n_bins),
                   JPS._bin_scene(jdesc, float(lam[k_mid]), ks, n_bins))
        for em, jem in zip(desc["emitters"], jdesc["emitters"]):
            key = "intensity" if "intensity" in em and "spectrum" not in em else "radiance"
            for k in range(n_bins):
                assert PS._emitter_bin(em, k, n_bins, key) == JPS._emitter_bin(jem, k, n_bins, key)
    em = {"spectrum": {"type": "values", "values": list(np.linspace(0.1, 0.8, 4))}}
    assert [PS._emitter_bin(em, k, 4) for k in range(4)] == \
        [JPS._emitter_bin(em, k, 4) for k in range(4)]
