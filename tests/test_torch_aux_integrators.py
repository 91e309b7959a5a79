"""The port's auxiliary integrators and the CLI's ``-I`` against the JAX
package on the CPU: ``render_direct``, ``render_ao``, every
``render_field`` field, ``render_multichannel`` with its EXR round trip
and ``render_adaptive`` on the Cornell box; then the CLI's every
integrator choice at 8x8.

Tolerances: images' means within 1e-3 relative and >= 99% of pixels
within 1e-3 (XLA on the CPU contracts multiply-adds); the adaptive
renderer's per-pixel sample counts equal on >= 99% of pixels.

The field AOVs shoot one ray through each pixel's centre, and at 16x16
two of those centres lie on a quad's diagonal of the Cornell box: the
reference's dense oracle, its multiply-adds contracted by XLA, misses
both triangles there (a crack), where the port's routes hit one
(``reference_cracks``).  A field's mean is compared over the other
pixels, and the cracks are held to that and to fewer than 1% of the
pixels.  On a miss the uv field is zero in the port, like every other
surface field; the reference's reads triangle 0's UVs at its oracle's
barycentrics of no hit, so uv is compared where the reference's ray hit."""
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch import render as cli
from mitsuba_path_guiding_torch.integrators import aux_integrators as aux
from mitsuba_path_guiding_torch.integrators import bdpt, ptracer, vpl
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box
from mitsuba_path_guiding_tpu.integrators import aux_integrators as jaux
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from torch_port_parity import frac_close, port_scene

W = H = 16
IMG_RTOL = 1e-3


@pytest.fixture(scope="module")
def cornell():
    jscene = j_build_scene(jscenes.cornell_box())
    return jscene, port_scene(jscene)


def _cfgs(**kw):
    base = dict(width=W, height=H, spp=2, max_depth=3, seed=1)
    base.update(kw)
    return RenderConfig(**base), JRenderConfig(**base, use_bvh=False)


def _assert_image(got, want, keep=None):
    """``keep``: the (H, W) pixels whose mean is compared (all if None)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    g, w = (got, want) if keep is None else (got[keep], want[keep])
    assert float(np.abs(w).mean()) > 0.0
    assert abs(float(np.abs(g).mean()) / float(np.abs(w).mean()) - 1.0) < IMG_RTOL
    assert frac_close(g, w, rtol=IMG_RTOL, atol=1e-6) >= 0.99


@pytest.fixture(scope="module")
def reference_cracks(cornell):
    """(H, W) pixels whose centre ray the reference's dense oracle misses
    and the port's tiled route hits, as the prim_index fields show; every
    other pixel's prim is equal."""
    jscene, scene = cornell
    cfg, jcfg = _cfgs()
    prim = aux.render_field(scene, cfg, "prim_index").numpy()[..., 0]
    jprim = np.asarray(jaux.render_field(jscene, jcfg, "prim_index"))[..., 0]
    cracks = (jprim < 0) & (prim >= 0)
    np.testing.assert_array_equal(prim[~cracks], jprim[~cracks])
    assert (jprim < 0).any() and (prim >= 0).mean() > 0.5
    # the port's dense oracle, which the tiled route is held to, hits there too
    brute = aux.render_field(scene, cfg._replace(accel="brute"), "prim_index").numpy()[..., 0]
    np.testing.assert_array_equal(brute, prim)
    assert cracks.mean() < 0.01
    return cracks, jprim < 0


def test_render_direct_matches(cornell):
    jscene, scene = cornell
    cfg, jcfg = _cfgs()
    img = aux.render_direct(scene, cfg)
    _assert_image(img, jaux.render_direct(jscene, jcfg))
    assert torch.equal(img, render(scene, cfg._replace(max_depth=1)))


def test_render_ao_matches(cornell):
    jscene, scene = cornell
    cfg, jcfg = _cfgs(spp=4)
    img = aux.render_ao(scene, cfg)
    _assert_image(img, jaux.render_ao(jscene, jcfg))
    assert 0.05 < float(img.mean()) < 0.95  # a partly occluded box interior


@pytest.mark.parametrize("field", aux.FIELD_NAMES)
def test_render_field_matches(cornell, reference_cracks, field):
    jscene, scene = cornell
    cfg, jcfg = _cfgs()
    cracks, ref_miss = reference_cracks
    img = aux.render_field(scene, cfg, field)
    keep = ~cracks
    if field == "uv":
        keep = ~ref_miss
        assert (img.numpy()[ref_miss & ~cracks] == 0.0).all()
    _assert_image(img, jaux.render_field(jscene, jcfg, field), keep=keep)


def test_render_multichannel_exr_roundtrip(cornell, reference_cracks, tmp_path):
    from mitsuba_path_guiding_torch.film.exr import read_exr

    jscene, scene = cornell
    cfg, jcfg = _cfgs()
    chans = ["path", "albedo", "distance", "ao", "direct"]
    out = aux.render_multichannel(scene, cfg, chans)
    want = jaux.render_multichannel(jscene, jcfg, chans)
    assert list(out) == chans
    for ch in chans:
        _assert_image(out[ch], want[ch],
                      keep=~reference_cracks[0] if ch in aux.FIELD_NAMES else None)
    path = str(tmp_path / "multi.exr")
    aux.write_multichannel_exr(path, out)
    back = read_exr(path)
    back = back[0] if isinstance(back, tuple) else back
    np.testing.assert_array_equal(np.stack([back[c] for c in "RGB"], -1), out["path"].numpy())
    for ch in chans[1:]:
        np.testing.assert_array_equal(np.stack([back[f"{ch}.{c}"] for c in "RGB"], -1),
                                      out[ch].numpy())


def test_normal_quantile():
    assert abs(aux._normal_quantile(0.05) - 1.959964) < 1e-4
    assert aux._normal_quantile(0.32) == jaux._normal_quantile(0.32)


def test_render_adaptive_matches(cornell):
    """8x8 pixels, rounds of 2 spp up to 8: the per-pixel sample counts
    (which rounds each pixel took) and the image against the reference's."""
    jscene, scene = cornell
    cfg, jcfg = _cfgs(width=8, height=8)
    kw = dict(base_spp=2, max_sample_factor=4, max_error=0.05)
    img, info = aux.render_adaptive(scene, cfg, **kw)
    jimg, jinfo = jaux.render_adaptive(jscene, jcfg, **kw)
    assert (info["spp"] == jinfo["spp"]).mean() >= 0.99
    assert info["spp"].min() >= 2 and info["spp"].max() == 8
    assert len(np.unique(info["spp"])) > 1  # the criterion tells pixels apart
    _assert_image(img, jimg)
    assert frac_close(info["ci_width"], jinfo["ci_width"], rtol=IMG_RTOL) >= 0.99


def test_render_adaptive_capped_pixels_equal_a_uniform_render():
    """With max_error 0 every pixel runs to the cap, and its accumulator is
    the uniform render's at that spp (the JAX package's check)."""
    from mitsuba_path_guiding_torch.integrators.render import render_wave

    scene = build_scene(cornell_box(), device="cpu")
    cfg = RenderConfig(width=4, height=4, spp=4, max_depth=3, seed=5)
    img, info = aux.render_adaptive(scene, cfg, base_spp=2, max_sample_factor=2, max_error=0.0)
    capped = info["spp"] == 4
    assert capped.sum() >= 8
    pix = torch.arange(16)
    acc = torch.zeros((16, 3))
    for s in range(4):
        acc = acc + render_wave(scene, cfg, pix, torch.full_like(pix, s))[1]
    np.testing.assert_array_equal(img.numpy()[capped], (acc / 4).reshape(4, 4, 3).numpy()[capped])
    # the others stopped after the pilot with a zero interval (no variance)
    assert (info["ci_width"][~capped] == 0.0).all()


# ---- the CLI's -I

CLI_FUNCS = {"path": render, "direct": aux.render_direct, "ao": aux.render_ao,
             "ptracer": ptracer.render_ptracer, "bdpt": bdpt.render_bdpt,
             "vpl": vpl.render_vpl}


@pytest.mark.parametrize("name", sorted(CLI_FUNCS))
def test_cli_integrator_renders(tmp_path, name):
    out = str(tmp_path / f"{name}.npy")
    assert cli.main(["cornell", "-I", name, "-o", out, "-r", "8x8", "-s", "2", "-d", "3",
                     "--seed", "3", "--device", "cpu"]) == 0
    img = np.load(out)
    scene = build_scene(cornell_box(), device="cpu")
    want = CLI_FUNCS[name](scene, RenderConfig(width=8, height=8, spp=2, max_depth=3, seed=3))
    np.testing.assert_array_equal(img, want.numpy())
    assert np.isfinite(img).all() and img.mean() > 0.0


def test_cli_guided_is_the_default(tmp_path):
    args = ["cornell", "-r", "8x8", "-s", "2", "--device", "cpu"]
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    assert cli.main(args + ["-I", "guided", "-o", a]) == 0
    assert cli.main(args + ["-o", b]) == 0
    assert np.isfinite(np.load(a)).all() and np.load(a).mean() > 0.0
    np.testing.assert_array_equal(np.load(a), np.load(b))


# the integrators that raised NotImplementedError before slice 10 ported
# them: the CLI now renders each (tests/test_torch_chains.py and
# tests/test_torch_photons.py hold them to their functions and to JAX)
FORMERLY_UNPORTED = ("pssmlt", "mlt", "erpt", "sppm", "photonmapper")


@pytest.mark.parametrize("name", FORMERLY_UNPORTED)
def test_cli_unported_integrators_raise(tmp_path, name):
    out = str(tmp_path / "x.npy")
    assert name in cli.INTEGRATORS
    assert cli.main(["cornell", "-I", name, "-o", out, "-r", "4x4", "-s", "1", "-d", "2",
                     "--device", "cpu"]) == 0
    img = np.load(out)
    assert img.shape == (4, 4, 3) and np.isfinite(img).all() and img.min() >= 0.0
    assert img.mean() > 0.0


def test_cli_denoise_needs_guided(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["cornell", "-I", "bdpt", "--denoise", "-o", str(tmp_path / "x.npy"),
                  "--device", "cpu"])
