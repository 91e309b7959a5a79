"""The port's file loaders against the JAX package's: COLLADA
(``scene/collada.py``), the OpenVDB codec (``scene/vdb.py``) and
``scene/volume.py`` ``vdb_to_dense``, heightfields read from .npy, .pfm
and .exr files.  Twins of tests/test_collada.py and tests/test_vdb.py;
every result also equal to JAX's on the same file."""
import numpy as np
import pytest
import torch
from torch_port_parity import share_cores  # noqa: F401  (caps torch's threads)

from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.collada import load_dae
from mitsuba_path_guiding_torch.scene.transforms import apply_points, look_at
from mitsuba_path_guiding_torch.scene.vdb import VdbGrid, read_vdb, write_vdb
from mitsuba_path_guiding_torch.scene.volume import load_volume_spec, vdb_to_dense
from mitsuba_path_guiding_tpu.scene import vdb as jvdb
from mitsuba_path_guiding_tpu.scene import volume as jvolume
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.collada import load_dae as j_load_dae
from test_torch_scene import _compare
from test_torch_xml_loader import assert_same

# tests/test_collada.py's asset
DAE = '''<?xml version="1.0"?>
<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" version="1.4.1">
 <asset><up_axis>{up}</up_axis></asset>
 <library_effects>
  <effect id="redfx"><profile_COMMON><technique sid="c"><lambert>
   <diffuse><color>0.8 0.1 0.1 1</color></diffuse></lambert></technique></profile_COMMON></effect>
 </library_effects>
 <library_materials>
  <material id="redmat"><instance_effect url="#redfx"/></material>
 </library_materials>
 <library_geometries>
  <geometry id="quad"><mesh>
   <source id="pos"><float_array id="pa" count="12">-1 -1 0 1 -1 0 1 1 0 -1 1 0</float_array>
    <technique_common><accessor source="#pa" count="4" stride="3"/></technique_common></source>
   <vertices id="vv"><input semantic="POSITION" source="#pos"/></vertices>
   <triangles material="m0" count="2">
    <input semantic="VERTEX" source="#vv" offset="0"/>
    <p>0 1 2 0 2 3</p>
   </triangles>
  </mesh></geometry>
 </library_geometries>
 <library_visual_scenes>
  <visual_scene id="scene">
   <node><translate>0 0 1</translate>
    <instance_geometry url="#quad">
     <bind_material><technique_common>
      <instance_material symbol="m0" target="#redmat"/>
     </technique_common></bind_material>
    </instance_geometry>
   </node>
  </visual_scene>
 </library_visual_scenes>
</COLLADA>'''


def test_dae_geometry_materials_render(tmp_path):
    f = tmp_path / "s.dae"
    f.write_text(DAE.format(up="Y_UP"))
    desc = load_dae(str(f))
    assert_same(desc, j_load_dae(str(f)))
    assert len(desc["shapes"]) == 1
    sh = desc["shapes"][0]
    assert sh["faces"].shape == (2, 3)
    np.testing.assert_allclose(sh["bsdf"]["reflectance"], [0.8, 0.1, 0.1])
    extra = {"sensor": {"type": "orthographic", "to_world": look_at([0, 0, -3], [0, 0, 1])},
             "emitters": [{"type": "constant", "radiance": [1.0] * 3}]}
    scene = build_scene({**desc, **extra}, device="cpu")
    _compare(scene, j_build_scene({**j_load_dae(str(f)), **extra}), "scene")
    img = render(scene, RenderConfig(width=16, height=16, spp=8, max_depth=2)).numpy()
    assert np.isfinite(img).all()
    assert img[8, 8, 0] > 1.5 * img[8, 8, 2]  # the quad is red


def test_dae_z_up_conversion(tmp_path):
    """Z_UP assets rotate into the Y-up convention, as in JAX."""
    f = tmp_path / "z.dae"
    f.write_text(DAE.format(up="Z_UP"))
    desc = load_dae(str(f))
    assert_same(desc, j_load_dae(str(f)))
    v = apply_points(desc["shapes"][0]["to_world"], desc["shapes"][0]["vertices"])
    np.testing.assert_allclose(v[:, 1], 1.0, atol=1e-6)


@pytest.fixture
def smoke():
    rng = np.random.default_rng(11)
    data = rng.random((20, 17, 9)).astype(np.float32)
    data[data < 0.3] = 0.0  # sparsity for the mask paths
    return data


def _same_grids(got, want):
    assert [g.name for g in got] == [g.name for g in want]
    for g, w in zip(got, want):
        assert g.data.dtype == w.data.dtype and g.data.tobytes() == w.data.tobytes()
        assert tuple(g.origin) == tuple(w.origin)
        np.testing.assert_array_equal(g.voxel_size, w.voxel_size)
        np.testing.assert_array_equal(g.translation, w.translation)


@pytest.mark.parametrize("compression", ["none", "zip"])
def test_roundtrip_dense(tmp_path, smoke, compression):
    """The port's writer and reader round-trip a sparse grid; its file is
    the JAX writer's byte for byte, and each package reads the other's."""
    p, jp = str(tmp_path / "s.vdb"), str(tmp_path / "j.vdb")
    kw = dict(origin=(3, -5, 10), voxel_size=(0.5, 0.5, 0.5), translation=(1.0, 2.0, 3.0))
    write_vdb(p, [VdbGrid("density", smoke, **kw)], compression=compression)
    jvdb.write_vdb(jp, [jvdb.VdbGrid("density", smoke, **kw)], compression=compression)
    back = read_vdb(p)
    _same_grids(back, jvdb.read_vdb(p))
    _same_grids(read_vdb(jp), back)
    b = back[0]
    s = np.asarray(kw["origin"]) - np.asarray(b.origin)
    np.testing.assert_array_equal(b.data[s[0]:s[0] + 20, s[1]:s[1] + 17, s[2]:s[2] + 9], smoke)
    assert abs(b.data.sum() - smoke.sum()) < 1e-3
    assert np.allclose(b.voxel_size, 0.5) and np.allclose(b.translation, (1.0, 2.0, 3.0))


def test_multigrid_and_missing_name(tmp_path, smoke):
    p = str(tmp_path / "m.vdb")
    write_vdb(p, [VdbGrid("density", smoke, (0, 0, 0)),
                  VdbGrid("temperature", smoke * 2.0, (0, 0, 0))])
    assert [g.name for g in read_vdb(p)] == ["density", "temperature"]
    with pytest.raises(KeyError, match="flames") as port:
        vdb_to_dense(p, "flames")
    with pytest.raises(KeyError) as ref:
        jvolume.vdb_to_dense(p, "flames")
    assert str(port.value) == str(ref.value)


def test_vdb_to_dense_world_bounds(tmp_path, smoke):
    p = str(tmp_path / "w.vdb")
    write_vdb(p, [VdbGrid("density", smoke, origin=(0, 0, 0), voxel_size=(0.1, 0.1, 0.1))])
    dense, aabb = vdb_to_dense(p, "density")
    j_dense, j_aabb = jvolume.vdb_to_dense(p, "density")
    assert dense.tobytes() == j_dense.tobytes() and dense.shape == j_dense.shape
    assert aabb.tobytes() == j_aabb.tobytes()
    assert dense.ndim == 3 and dense.sum() == pytest.approx(smoke.sum(), rel=1e-5)
    assert np.all(aabb[1] - aabb[0] >= np.array([0.9, 1.7, 2.0]) * 0.1 - 1e-5)


def test_vdbvolume_spec_pipeline(tmp_path, smoke):
    """A vdbvolume spec loads as in JAX, and a heterogeneous medium read
    from the .vdb file compiles to JAX's MediumData."""
    p = str(tmp_path / "p.vdb")
    write_vdb(p, [VdbGrid("density", smoke, (0, 0, 0))])
    spec = {"type": "vdbvolume", "filename": p}
    grid, aabb = load_volume_spec(spec)
    j_grid, j_aabb = jvolume.load_volume_spec(spec)
    assert grid.tobytes() == j_grid.tobytes() and aabb.tobytes() == j_aabb.tobytes()
    assert grid.sum() == pytest.approx(smoke.sum(), rel=1e-5)
    from mitsuba_path_guiding_torch.scene import scenes as tscenes
    from mitsuba_path_guiding_tpu.scene import scenes as jscenes

    def desc(mod):
        d = mod.cornell_box()
        d["medium"] = {"sigma_a": [0.1] * 3, "sigma_s": [0.5] * 3, "density": spec}
        return d

    scene = build_scene(desc(tscenes), device="cpu")
    assert scene.medium.heterogeneous
    _compare(scene.medium, j_build_scene(desc(jscenes)).medium, "medium")


def test_not_a_vdb(tmp_path):
    p = tmp_path / "bad.vdb"
    p.write_bytes(b"not a vdb file at all")
    with pytest.raises(ValueError, match="not an OpenVDB"):
        read_vdb(str(p))


@pytest.mark.parametrize("ext", ["npy", "pfm", "exr"])
def test_heightfield_from_file(tmp_path, ext):
    """A heightfield named by ``filename`` (an RGB image: the mean over its
    channels) compiles to JAX's arrays, and renders."""
    from mitsuba_path_guiding_torch.film.film import write_image
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box as t_cornell
    from mitsuba_path_guiding_tpu.scene.scenes import cornell_box as j_cornell

    rs = np.random.default_rng(5)
    img = rs.random((12, 10, 3)).astype(np.float32)
    path = str(tmp_path / f"h.{ext}")
    write_image(path, img)

    def desc(mod_cornell):
        d = mod_cornell()
        d["shapes"] = d["shapes"][:5] + d["shapes"][7:] + [{
            "type": "heightfield", "filename": path, "scale": 0.3,
            "to_world": np.array([[0.5, 0, 0, 0], [0, 0, 0.5, 0.2], [0, -0.5, 0, 0],
                                  [0, 0, 0, 1.0]]),
            "bsdf": {"type": "diffuse"}}]
        return d

    scene = build_scene(desc(t_cornell), device="cpu")
    _compare(scene, j_build_scene(desc(j_cornell)), "scene")
    assert scene.geo.p0.shape[0] == 36 - 24 + 2 * 11 * 9
    out = render(scene, RenderConfig(width=16, height=16, spp=2, max_depth=3))
    assert bool(torch.isfinite(out).all())
