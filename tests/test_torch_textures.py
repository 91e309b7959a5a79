"""The port's textures against the JAX package on the CPU: the atlas and
its mip pyramid bit for bit, the four fetches (bilinear, trilinear,
nearest, EWA) on 4096 lanes from the same seeded inputs, every texture
kind, the bump and normal maps, the cloth and an envmap read from a file
compiled array for array equal to the JAX build; and twins of the JAX
package's tests/test_textures.py, test_mipmap.py and test_bitmap.py run
through the port."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitsuba_path_guiding_torch.film import bitmap
from mitsuba_path_guiding_torch.film.film import write_image
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.models import texture
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.transforms import look_at, scale
from mitsuba_path_guiding_tpu.models import texture as jtexture
from mitsuba_path_guiding_tpu.scene import scenes as jscenes
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from test_torch_scene import _compare
from torch_port_parity import frac_close

N = 4096


def _images():
    rng = np.random.default_rng(3)
    chk = np.zeros((64, 64, 3), np.float32)
    yy, xx = np.meshgrid(range(64), range(64), indexing="ij")
    chk[((xx // 4 + yy // 4) % 2).astype(bool)] = 1.0
    return [chk, rng.random((23, 31, 3)).astype(np.float32),
            rng.random((1, 1, 3)).astype(np.float32), rng.random((40, 12, 4)).astype(np.float32)]


@pytest.fixture(scope="module")
def atlases():
    imgs = _images()
    ja, js = jtexture.build_atlas(imgs)
    ta, ts = texture.build_atlas(imgs, device="cpu")
    return (ja, js), (ta, ts)


def test_atlas_and_mips_bit_equal(atlases):
    (ja, js), (ta, ts) = atlases
    assert tuple(ta.shape) == (4, 128, 64, 3)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # no texture: the 1 x 2 x 1 placeholder
    ea, es = texture.build_atlas([])
    np.testing.assert_array_equal(ea.numpy(), np.asarray(jtexture.build_atlas([])[0]))
    np.testing.assert_array_equal(es.numpy(), np.ones((1, 2), np.float32))


@pytest.mark.parametrize("spec", [
    {"type": "checkerboard", "uscale": 3, "vscale": 5, "color0": [0.9, 0.1, 0.2]},
    {"type": "gridtexture", "line_width": 0.05, "uscale": 4},
])
def test_procedural_rasterizes_equal(spec):
    np.testing.assert_array_equal(texture.rasterize_procedural(spec, res=64),
                                  jtexture.rasterize_procedural(spec, res=64))


def _lanes(seed=0):
    rng = np.random.default_rng(seed)
    tid = rng.integers(-1, 4, N).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (N, 2)).astype(np.float32)
    lod = rng.uniform(-1.0, 9.0, N).astype(np.float32)
    theta = rng.uniform(0, np.pi, N)
    major = rng.uniform(0.1, 12.0, N) / 64.0
    minor = major / rng.uniform(1.0, 12.0, N)
    duv0 = np.stack([np.cos(theta) * major, np.sin(theta) * major], -1).astype(np.float32)
    duv1 = np.stack([-np.sin(theta) * minor, np.cos(theta) * minor], -1).astype(np.float32)
    return tid, uv, lod, duv0, duv1


@pytest.mark.parametrize("fetch", ["bilinear", "trilinear", "nearest", "ewa"])
def test_fetches_match_reference(atlases, fetch):
    """4096 lanes, UVs outside [0, 1) (the repeat wrap), ids of every
    texture and -1 (texture 0), lods below 0 and past the last level.  XLA
    on the CPU forms FMAs in the bilinear blends: rtol 1e-6; the nearest
    fetch is indexing alone: bit-equal; EWA's Gaussian weights: rtol 1e-5."""
    (ja, js), (ta, ts) = atlases
    tid, uv, lod, duv0, duv1 = _lanes()
    T = torch.from_numpy
    if fetch == "bilinear":
        got = texture.sample_atlas(ta, ts, T(tid), T(uv))
        want = jtexture.sample_atlas(ja, js, jnp.asarray(tid), jnp.asarray(uv))
    elif fetch == "trilinear":
        got = texture.sample_atlas(ta, ts, T(tid), T(uv), lod=T(lod))
        want = jtexture.sample_atlas(ja, js, jnp.asarray(tid), jnp.asarray(uv),
                                     lod=jnp.asarray(lod))
    elif fetch == "nearest":
        got = texture.sample_atlas_nearest(ta, ts, T(tid), T(uv))
        want = jtexture.sample_atlas_nearest(ja, js, jnp.asarray(tid), jnp.asarray(uv))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    else:
        got = texture.sample_atlas_ewa(ta, ts, T(tid), T(uv), T(duv0), T(duv1))
        want = jtexture.sample_atlas_ewa(ja, js, jnp.asarray(tid), jnp.asarray(uv),
                                         jnp.asarray(duv0), jnp.asarray(duv1))
    rtol = 1e-5 if fetch == "ewa" else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=1e-6)


def _plane(bsdf, shape=None, emitters=None):
    sh = dict(shape or {"type": "rectangle"})
    sh["bsdf"] = bsdf
    return {"sensor": {"type": "orthographic", "to_world": look_at([0, 0, -2.0], [0, 0, 0])},
            "shapes": [sh],
            "emitters": emitters or [{"type": "constant", "radiance": [1.0, 1.0, 1.0]}]}


_RNG_IMG = np.random.default_rng(5).random((12, 20, 3)).astype(np.float32)
_QUAD = {"type": "trimesh",
         "vertices": np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float64),
         "faces": np.array([[0, 1, 2], [0, 2, 3]]),
         "colors": np.array([[1, 0, 0], [1, 0, 0], [0, 1, 0], [0, 1, 0]], np.float64),
         "normals": np.tile([0.0, 0.0, 1.0], (4, 1))}


def _file_texture(ext):
    def make(d):
        path = os.path.join(d, f"tex.{ext}")
        if ext == "npy":
            np.save(path, _RNG_IMG)
        else:
            write_image(path, _RNG_IMG)
        return _plane({"type": "diffuse", "texture": {"type": "bitmap", "filename": path}})
    return make


def _env_file(d):
    path = os.path.join(d, "sky.pfm")
    write_image(path, np.random.default_rng(9).random((16, 32, 3)).astype(np.float32) * 2.0)
    return _plane({"type": "diffuse"}, emitters=[{"type": "envmap", "filename": path,
                                                  "scale": 1.5}])


def _textured_box(mod):
    sc = mod.cornell_box()
    sc["shapes"][0]["bsdf"] = {"type": "diffuse", "texture": {"type": "checkerboard"}}
    sc["shapes"][1]["bsdf"] = {"type": "diffuse", "texture": {"type": "checkerboard"}}
    sc["shapes"][3]["bsdf"] = {"type": "bumpmap", "bsdf": {"type": "blendbsdf", "bsdfs": [
        {"type": "diffuse"}, {"type": "roughconductor", "alpha": 0.2}]},
        "texture": {"type": "gridtexture"}}
    return sc


KINDS = {
    "bitmap_image": lambda d: _plane({"type": "diffuse", "texture": {"type": "bitmap",
                                                                     "image": _RNG_IMG}}),
    "bitmap_pfm": _file_texture("pfm"),
    "bitmap_npy": _file_texture("npy"),
    "bitmap_exr": _file_texture("exr"),
    "scale": lambda d: _plane({"type": "diffuse", "texture": {
        "type": "scale", "scale": [0.5, 0.25, 2.0],
        "texture": {"type": "bitmap", "image": _RNG_IMG}}}),
    "scale_constant": lambda d: _plane({"type": "diffuse", "texture": {"type": "scale",
                                                                       "scale": 0.3}}),
    "checkerboard": lambda d: _plane({"type": "roughplastic", "texture": {
        "type": "checkerboard", "uscale": 8, "vscale": 8}}),
    "gridtexture": lambda d: _plane({"type": "diffuse", "texture": {"type": "gridtexture"}}),
    "vertexcolors": lambda d: _plane({"type": "diffuse", "texture": {"type": "vertexcolors"}},
                                     shape=_QUAD),
    "vertexcolors_none": lambda d: _plane({"type": "diffuse",
                                           "texture": {"type": "vertexcolors"}}),
    "curvature": lambda d: _plane({"type": "diffuse", "texture": {
        "type": "curvature", "curvature": "gaussian", "scale": 2.0}},
        shape={"type": "sphere", "to_world": np.diag([0.8, 0.8, 0.8, 1.0])}),
    "wireframe": lambda d: _plane({"type": "diffuse", "texture": {
        "type": "wireframe", "interior_color": [0.8] * 3, "edge_color": [0.1, 0.0, 0.0],
        "line_width": 0.15}}),
    "bumpmap": lambda d: _plane({"type": "bumpmap", "scale": 0.7, "bsdf": {"type": "roughplastic"},
                                 "texture": {"type": "bitmap", "image": _RNG_IMG}}),
    "normalmap": lambda d: _plane({"type": "normalmap", "bsdf": {"type": "coating"},
                                   "texture": {"type": "bitmap", "image": _RNG_IMG}}),
    "irawan": lambda d: _plane({"type": "irawan", "repeatU": 4, "repeatV": 3}),
    "envmap_file": _env_file,
    "cornell_textured": lambda d: _textured_box(tscenes),
}


@pytest.mark.parametrize("kind", list(KINDS))
def test_texture_kinds_compile_equal(kind, tmp_path):
    """Every texture kind, bumpmap, normalmap, irawan and an envmap file:
    each field of the port's compile equals the JAX build's, the atlas,
    its sizes, geo.vcol and the packed material columns included."""
    desc = KINDS[kind](str(tmp_path))
    ref = j_build_scene(desc)
    got = build_scene(desc, device="cpu")
    _compare(got, ref, kind)
    assert (got.geo.vcol is None) == (ref.geo.vcol is None)
    if kind.startswith("bitmap") or kind in ("irawan", "bumpmap", "cornell_textured"):
        assert got.textures.shape[0] * got.textures.shape[1] > 2


def test_lod_zero_is_bilinear_and_levels_blur(atlases):
    """Twin of test_mipmap.py's trilinear check on the port's fetch."""
    ta, ts = texture.build_atlas([_images()[0]])
    tid = torch.zeros((64,), dtype=torch.int32)
    uv = torch.stack([torch.linspace(0.01, 0.99, 64), torch.linspace(0.07, 0.93, 64)], dim=-1)
    sharp = texture.sample_atlas(ta, ts, tid, uv, lod=torch.zeros(64)).numpy()
    base = texture.sample_atlas(ta, ts, tid, uv).numpy()
    np.testing.assert_allclose(sharp, base, atol=1e-6)
    blurred = texture.sample_atlas(ta, ts, tid, uv, lod=torch.full((64,), 5.0)).numpy()
    assert blurred.std() < 0.05 and abs(blurred.mean() - 0.5) < 0.05
    mid = texture.sample_atlas(ta, ts, tid, uv, lod=torch.full((64,), 2.5)).numpy()
    assert sharp.std() > mid.std() > blurred.std()


def test_pyramid_layout_and_means():
    ta, _ = texture.build_atlas([_images()[0]])
    a = ta[0].numpy()
    assert a.shape == (128, 64, 3)
    assert abs(a[:64, :64].mean() - 0.5) < 1e-6
    off5 = 128 - (128 >> 5)
    np.testing.assert_allclose(a[off5: off5 + 2, :2], 0.5, atol=1e-6)


def test_ewa_anisotropy():
    """Twin of test_mipmap.py: a footprint along a stripe keeps its value,
    one across the stripes averages them."""
    img = np.zeros((64, 64, 3), np.float32)
    img[::4] = 1.0
    img[1::4] = 1.0
    ta, ts = texture.build_atlas([img])
    n = 4
    tid = torch.zeros((n,), dtype=torch.int32)
    uv = torch.tensor([[0.25, 1.0 - 1.0 / 64.0]] * n)
    thin, wide = 0.4 / 64.0, 4.0 / 64.0
    along = texture.sample_atlas_ewa(ta, ts, tid, uv, torch.tensor([[wide, 0.0]] * n),
                                     torch.tensor([[0.0, thin]] * n))
    across = texture.sample_atlas_ewa(ta, ts, tid, uv, torch.tensor([[0.0, wide]] * n),
                                      torch.tensor([[thin, 0.0]] * n))
    assert float(along[0, 0]) > 0.85
    assert abs(float(across[0, 0]) - 0.5) < 0.1


def test_ewa_error_bound_vs_supersampled_footprint():
    """Twin of test_mipmap.py: the 81-tap window with the anisotropy
    clamp against a brute-force Gaussian footprint average."""
    rng = np.random.default_rng(4)
    H = W = 64
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * xx / W * 3) * np.cos(2 * np.pi * yy / H * 2),
        0.5 + 0.3 * np.cos(2 * np.pi * (xx + yy) / W * 2),
        0.5 + 0.2 * np.sin(2 * np.pi * yy / H * 4),
    ], axis=-1).astype(np.float32)
    ta, ts = texture.build_atlas([img])
    n = 24
    uv = rng.uniform(0.25, 0.75, (n, 2)).astype(np.float32)
    theta = rng.uniform(0, np.pi, n)
    major = rng.uniform(2.0, 8.0, n) / W
    minor = major / rng.uniform(1.0, texture.MAX_ANISO, n)
    duv0 = np.stack([np.cos(theta) * major, np.sin(theta) * major], -1).astype(np.float32)
    duv1 = np.stack([-np.sin(theta) * minor, np.cos(theta) * minor], -1).astype(np.float32)
    got = texture.sample_atlas_ewa(ta, ts, torch.zeros((n,), dtype=torch.int32),
                                   torch.from_numpy(uv), torch.from_numpy(duv0),
                                   torch.from_numpy(duv1)).numpy()
    ref = np.zeros((n, 3))
    ss = np.linspace(-1, 1, 41)
    SA, SB = np.meshgrid(ss, ss, indexing="ij")
    wgt = np.exp(-2.0 * (SA ** 2 + SB ** 2))
    for i in range(n):
        pu = uv[i, 0] + SA * duv0[i, 0] + SB * duv1[i, 0]
        pv = uv[i, 1] + SA * duv0[i, 1] + SB * duv1[i, 1]
        px = np.clip((pu % 1.0) * W, 0, W - 1).astype(int)
        py = np.clip(((1.0 - pv) % 1.0) * H, 0, H - 1).astype(int)
        ref[i] = (img[py, px] * wgt[..., None]).sum((0, 1)) / wgt.sum()
    rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)
    assert np.median(rel) < 0.10, np.median(rel)
    assert rel.max() < 0.35, rel.max()


# ---------------------------------------------------------------- renders

def _render(desc, spp=32, w=32, depth=2):
    return render(build_scene(desc, device="cpu"),
                  RenderConfig(width=w, height=w, spp=spp, max_depth=depth, seed=0)).numpy()


def test_scale_texture():
    base = {"type": "bitmap", "image": np.full((4, 4, 3), 0.8, np.float32)}
    img1 = _render(_plane({"type": "diffuse", "texture": base}), spp=8)
    img2 = _render(_plane({"type": "diffuse", "texture": {"type": "scale", "scale": 0.5,
                                                          "texture": base}}), spp=8)
    np.testing.assert_allclose(img2[8:-8, 8:-8].mean() / img1[8:-8, 8:-8].mean(), 0.5, rtol=0.05)


def test_wireframe_texture():
    img = _render(_plane({"type": "diffuse", "texture": {
        "type": "wireframe", "interior_color": [0.8] * 3, "edge_color": [0.0] * 3,
        "line_width": 0.15}}), spp=16, w=48)
    inner = img[10:-10, 10:-10].mean(axis=-1)
    assert np.isfinite(img).all()
    assert (inner > 0.5).any() and (inner < 0.25).any()


def test_vertexcolors_texture():
    img = _render(_plane({"type": "diffuse", "texture": {"type": "vertexcolors"}}, shape=_QUAD),
                  spp=64)
    bot, top = img[-6:, 8:-8], img[:6, 8:-8]
    lo, hi = (bot, top) if bot[..., 0].mean() > top[..., 0].mean() else (top, bot)
    assert lo[..., 0].mean() > 2.0 * lo[..., 1].mean()
    assert hi[..., 1].mean() > 2.0 * hi[..., 0].mean()


def test_curvature_texture():
    img = _render(_plane({"type": "diffuse", "texture": {"type": "curvature", "curvature": "mean",
                                                         "scale": 1.0}},
                         shape={"type": "sphere", "sphere_res": 16,
                                "to_world": np.diag([0.8, 0.8, 0.8, 1.0])}),
                  spp=16)
    center = img[12:-12, 12:-12]
    assert np.isfinite(img).all() and center[..., 0].mean() > 1.5 * center[..., 2].mean()


def test_wireframe_width_semantics():
    """The line width is a barycentric fraction: the edge area grows about
    linearly with it and does not change with the scene's scale."""
    def edge_fraction(lw, sc):
        desc = {"sensor": {"type": "orthographic",
                           "to_world": look_at([0, 0, -3 * sc], [0, 0, 0]) @ scale(sc)},
                "shapes": [{"type": "rectangle", "to_world": scale(sc), "bsdf": {
                    "type": "diffuse", "texture": {"type": "wireframe", "interior_color": [1.0] * 3,
                                                   "edge_color": [0.0] * 3, "line_width": lw}}}],
                "emitters": [{"type": "constant", "radiance": [1.0] * 3}]}
        return float((_render(desc, spp=16, w=64).mean(-1) < 0.25).mean())

    f1, f2, f3 = edge_fraction(0.05, 1.0), edge_fraction(0.10, 1.0), edge_fraction(0.05, 3.0)
    assert f1 > 0.02 and 1.5 < f2 / f1 < 2.6 and abs(f3 - f1) / f1 < 0.3, (f1, f2, f3)


def test_textured_render_with_cone_filtering():
    sc = {"sensor": {"type": "perspective", "fov": 60.0,
                     "to_world": look_at([0, 1.0, -3], [0, 0, 2])},
          "shapes": [{"type": "rectangle",
                      "to_world": np.array([[8, 0, 0, 0], [0, 0, 8, 0], [0, -8, 0, 0],
                                            [0, 0, 0, 1.0]]),
                      "bsdf": {"type": "diffuse", "texture": {"type": "checkerboard",
                                                              "uscale": 32, "vscale": 32}}}],
          "emitters": [{"type": "constant", "radiance": [1.0] * 3}]}
    img = render(build_scene(sc, device="cpu"),
                 RenderConfig(width=24, height=24, spp=8, max_depth=2, seed=1)).numpy()
    assert np.isfinite(img).all() and 0.05 < img.mean() < 1.5


# ---------------------------------------------------------------- bitmaps

@pytest.fixture
def hdr_img():
    rng = np.random.default_rng(7)
    img = rng.random((23, 31, 3)).astype(np.float32) * 4.0
    img[3:6, 4:9] = 0.0
    img[10, :] = 2.5
    return img


def test_rgbe_roundtrip_equals_reference(tmp_path, hdr_img):
    from mitsuba_path_guiding_tpu.film import bitmap as jbitmap

    p = str(tmp_path / "t.hdr")
    bitmap.write_hdr(p, hdr_img)
    back = bitmap.read_hdr(p)
    denom = np.maximum(hdr_img.max(axis=-1, keepdims=True), 1e-3)
    assert np.abs(back - hdr_img).max() / denom.max() < 0.02
    q = str(tmp_path / "j.hdr")
    jbitmap.write_hdr(q, hdr_img)
    with open(q, "rb") as fj, open(p, "rb") as fp:
        # the same bytes after the tool's name in the header
        assert fj.read().split(b"\n", 2)[2] == fp.read().split(b"\n", 2)[2]
    np.testing.assert_array_equal(back, jbitmap.read_hdr(q))


def test_rgbe_flat_scanline_narrow(tmp_path):
    img = np.random.default_rng(0).random((5, 4, 3)).astype(np.float32)
    p = str(tmp_path / "n.hdr")
    bitmap.write_hdr(p, img)
    assert np.abs(bitmap.read_hdr(p) - img).max() < 0.02


def test_ldr_png_jpeg_tga_bmp_roundtrip(tmp_path, hdr_img):
    pytest.importorskip("PIL")
    img = np.clip(hdr_img / 4.0, 0, 1)
    for ext, tol in [("png", 0.01), ("bmp", 0.01), ("tga", 0.01)]:
        p = str(tmp_path / f"t.{ext}")
        bitmap.save(p, img)
        back = bitmap.load(p)
        assert back.shape == img.shape and np.abs(back - img).max() < tol, ext
    p = str(tmp_path / "t.jpg")
    bitmap.save(p, img)
    back = bitmap.load(p)
    assert back.shape == img.shape and np.abs(back - img).mean() < 0.03


def test_ldr_without_pillow_names_it(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        bitmap.save(str(tmp_path / "x.png"), np.zeros((2, 2, 3), np.float32))


def test_load_save_dispatch_hdr_formats(tmp_path, hdr_img):
    for ext in ("exr", "pfm", "hdr", "npy"):
        p = str(tmp_path / f"t.{ext}")
        bitmap.save(p, hdr_img)
        back = bitmap.load(p)
        assert np.abs(back - hdr_img).max() < (0.02 if ext == "hdr" else 1e-5), ext


def test_unknown_format_raises(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        bitmap.load(str(tmp_path / "x.gif"))
    with pytest.raises(ValueError, match="unsupported"):
        bitmap.save(str(tmp_path / "x.gif"), np.zeros((2, 2, 3)))


@pytest.mark.parametrize("rfilter", ["box", "tent", "gaussian", "lanczos"])
def test_resample_equals_reference(rfilter):
    from mitsuba_path_guiding_tpu.film import bitmap as jbitmap

    img = np.random.default_rng(2).random((17, 13, 3)).astype(np.float32)
    np.testing.assert_array_equal(bitmap.resample(img, 40, 9, rfilter=rfilter),
                                  jbitmap.resample(img, 40, 9, rfilter=rfilter))
    const = bitmap.resample(np.full((17, 13, 3), 0.7, np.float32), 40, 9, rfilter=rfilter)
    assert const.shape == (9, 40, 3) and np.abs(const - 0.7).max() < 1e-5


def test_resample_energy_and_gradient():
    x = np.linspace(0, 1, 64, dtype=np.float32)
    img = np.broadcast_to(x[None, :, None], (64, 64, 1)).copy()
    out = bitmap.resample(img, 16, 16, rfilter="lanczos")
    assert abs(out.mean() - img.mean()) < 1e-3 and (np.diff(out[8, :, 0]) > 0).all()


def test_resample_upsample_and_grayscale():
    y, x = np.mgrid[0:8, 0:8] / 8.0
    img = np.stack([np.sin(2 * np.pi * x), np.cos(2 * np.pi * y), x * y],
                   axis=-1).astype(np.float32) * 0.4 + 0.5
    down = bitmap.resample(bitmap.resample(img, 32, 32), 8, 8)
    assert np.abs(down - img).mean() < 0.03
    g = bitmap.resample(np.random.default_rng(1).random((12, 9)).astype(np.float32), 18, 6,
                        rfilter="tent")
    assert g.shape == (6, 18) and (g >= 0).all()


def test_hdr_old_rle_roundtrip(tmp_path):
    w, h = 16, 2
    px = bytes([128, 64, 32, 130])
    payload = b"".join(px + bytes([1, 1, 1, 15]) for _ in range(h))
    hdr = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    p = tmp_path / "old_rle.hdr"
    p.write_bytes(hdr + payload)
    img = bitmap.read_hdr(str(p))
    assert img.shape == (h, w, 3) and np.allclose(img, img[0, 0]) and img[0, 0].max() > 0


def test_read_takes_the_reference_formats(tmp_path):
    """util._read: npy, pfm and exr, as the reference's; .hdr is refused."""
    from mitsuba_path_guiding_torch.util import _read
    from mitsuba_path_guiding_tpu.util import _read as j_read

    for ext in ("npy", "pfm", "exr"):
        p = str(tmp_path / f"t.{ext}")
        write_image(p, _RNG_IMG)
        np.testing.assert_array_equal(np.asarray(_read(p)), np.asarray(j_read(p)))
    with pytest.raises(ValueError, match="supported: npy, pfm, exr"):
        _read(str(tmp_path / "t.hdr"))


def test_textured_render_matches_reference():
    """render() of the textured Cornell box (checkerboard walls, a grid
    bump map under a blend) at 16x16, 4 spp, with the cone filtering a
    perspective camera turns on: per pixel rtol 1e-4 on >= 99% of pixels
    against the JAX package's render from the same seed."""
    from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JConfig
    from mitsuba_path_guiding_tpu.integrators.render import render as j_render

    cfg = dict(width=16, height=16, spp=4, max_depth=4, seed=3)
    img_j = np.asarray(j_render(j_build_scene(_textured_box(jscenes)), JConfig(**cfg)))
    img_t = render(build_scene(_textured_box(tscenes), device="cpu"), RenderConfig(**cfg)).numpy()
    assert np.isfinite(img_t).all()
    assert frac_close(img_t.reshape(-1, 3), img_j.reshape(-1, 3), rtol=1e-4) >= 0.99
