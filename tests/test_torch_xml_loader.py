"""The port's Mitsuba-XML loader (``scene/xml_loader.py``) against the JAX
package's: the same XML gives the same scene dict (keys equal, numpy
arrays bit for bit) and the dict compiles to the same arrays in both
packages.  Twins of tests/test_xml_loader.py's in-code tests; one case per
shape, BSDF, emitter, sensor, medium phase, transform tag and ``$key``
default; the Cornell box written as XML with ``<matrix>`` transforms
compiles and renders bit-equal to the built-in."""
import os

import numpy as np
import pytest
import torch
from torch_port_parity import share_cores  # noqa: F401  (caps torch's threads)

from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene import scenes as tscenes
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.xml_loader import (
    _SHAPES,
    _SUPPORTED_BSDFS,
    load_bsdfs_xml,
    load_scene_xml,
)
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.xml_loader import load_bsdfs_xml as j_load_bsdfs_xml
from mitsuba_path_guiding_tpu.scene.xml_loader import load_scene_xml as j_load_scene_xml
from test_torch_scene import _compare


def assert_same(a, b, path="desc"):
    """Deep equality of two loader outputs: the same keys and types,
    numpy arrays of one dtype and equal bits."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, (path, a, b)


def both(xml, **kw):
    """(port, JAX) loads of ``xml``, held equal."""
    got, want = load_scene_xml(xml, **kw), j_load_scene_xml(xml, **kw)
    assert_same(got, want)
    return got, want


def compiled_equal(port_desc, jax_desc):
    """Both packages compile their own dict; every array equal."""
    port = build_scene(port_desc, device="cpu")
    _compare(port, j_build_scene(jax_desc), "scene")
    return port


# --- twins of tests/test_xml_loader.py's in-code tests ----------------------

UNKNOWN_BSDF = """<scene version="0.5.0"><shape type="rectangle">
  <bsdf type="frobnicator"/></shape></scene>"""


def test_unknown_bsdf_raises_strict():
    with pytest.raises(ValueError, match="frobnicator") as port:
        load_scene_xml(UNKNOWN_BSDF)
    with pytest.raises(ValueError) as ref:
        j_load_scene_xml(UNKNOWN_BSDF)
    assert str(port.value) == str(ref.value)


def test_unknown_bsdf_degrades_permissive():
    with pytest.warns(UserWarning, match="frobnicator"):
        (desc, _), _ = both(UNKNOWN_BSDF, strict=False)
    assert desc["shapes"][0]["bsdf"]["type"] == "diffuse"


def test_unknown_emitter_raises_strict():
    xml = """<scene version="0.5.0"><emitter type="plasma_cannon"/></scene>"""
    with pytest.raises(ValueError, match="plasma_cannon") as port:
        load_scene_xml(xml)
    with pytest.raises(ValueError) as ref:
        j_load_scene_xml(xml)
    assert str(port.value) == str(ref.value)
    with pytest.warns(UserWarning, match="plasma_cannon"):
        both(xml, strict=False)


BUMP_SCENE = """
<scene version="0.6.0">
  <shape type="rectangle">
    <transform name="toWorld"><rotate x="1" angle="-90"/><scale value="2"/></transform>
    {BSDF}
  </shape>
  <emitter type="point"><point name="position" x="0" y="3" z="1"/>
    <spectrum name="intensity" value="20"/></emitter>
  <sensor type="perspective">
    <transform name="toWorld"><lookat origin="0,2,3" target="0,0,0" up="0,1,0"/></transform>
  </sensor>
</scene>
"""


def test_bumpmap_normalmap_xml_wiring():
    """The bumpmap wrapper reaches the compile (equal to JAX's) and changes
    the port's render against the bare child BSDF."""
    plain = '<bsdf type="diffuse"/>'
    bumped = ('<bsdf type="bumpmap">'
              '<texture type="checkerboard"><float name="uscale" value="8"/></texture>'
              '<float name="scale" value="4.0"/>'
              '<bsdf type="diffuse"/></bsdf>')
    normal = ('<bsdf type="normalmap">'
              '<texture type="checkerboard"><float name="uscale" value="8"/></texture>'
              '<bsdf type="diffuse"/></bsdf>')
    cfg = RenderConfig(width=16, height=16, spp=8, max_depth=2, seed=1)
    imgs = {}
    for name, b in (("plain", plain), ("bump", bumped), ("normal", normal)):
        (desc, _), (jdesc, _) = both(BUMP_SCENE.replace("{BSDF}", b))
        imgs[name] = render(compiled_equal(desc, jdesc), cfg).numpy()
    assert np.isfinite(imgs["bump"]).all()
    diff = np.abs(imgs["bump"] - imgs["plain"]).mean() / max(imgs["plain"].mean(), 1e-9)
    assert diff > 0.01, f"bump map had no shading effect (rel diff {diff})"


OLD_SCENE = """<scene version="0.4.0">
  <integrator type="path"><integer name="maxDepth" value="3"/></integrator>
  <camera type="perspective">
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="0,0,-3" target="0,0,0" up="0,1,0"/>
    </transform>
    <film type="exrfilm">
      <integer name="width" value="16"/>
      <integer name="height" value="16"/>
    </film>
  </camera>
  <shape type="rectangle">
    <bsdf type="lambertian"><rgb name="reflectance" value="0.6 0.5 0.4"/></bsdf>
  </shape>
  <luminaire type="constant"><rgb name="intensity" value="0.5 0.5 0.5"/></luminaire>
</scene>"""


def test_scene_version_migration():
    """A 0.4-era scene upgrades as in JAX, compiles equal and renders."""
    (desc, settings), (jdesc, _) = both(OLD_SCENE)
    assert settings["width"] == 16 and settings["integrator"] == "path"
    assert desc["shapes"][0]["bsdf"]["type"] == "diffuse"
    assert desc["emitters"][0]["type"] == "constant"
    scene = compiled_equal(desc, jdesc)
    img = render(scene, RenderConfig(width=16, height=16, spp=4, max_depth=3)).numpy()
    assert np.isfinite(img).all() and img.mean() > 0.01


def test_scene_version_migration_bsdf_renames():
    old = """<scene version="0.3.0">
      <bsdf type="roughmetal" id="m">
        <float name="alphaB" value="0.2"/>
      </bsdf>
      <shape type="sphere"><ref id="m"/></shape>
      <luminaire type="point"><rgb name="intensity" value="1 1 1"/></luminaire>
    </scene>"""
    (desc, _), (jdesc, _) = both(old)
    assert desc["shapes"][0]["bsdf"]["type"] == "roughconductor"
    assert abs(desc["shapes"][0]["bsdf"]["alpha"] - 0.2) < 1e-6
    compiled_equal(desc, jdesc)


def test_irawan_xml_properties_reach_weave(tmp_path):
    """irawan's filename, repeats and $identifier properties reach the
    weave compile; the compiled rows and the baked kd texture equal JAX's."""
    from mitsuba_path_guiding_torch.models.cloth import PLAIN_WEAVE
    from mitsuba_path_guiding_torch.scene.types import BSDFType

    wf = tmp_path / "param.weave"
    wf.write_text(PLAIN_WEAVE.replace("kd = {0.45, 0.4, 0.36}", "kd = $warp_kd"))
    xml = f"""<scene version="0.5.0">
      <shape type="rectangle">
        <bsdf type="irawan">
          <string name="filename" value="{wf}"/>
          <float name="repeatU" value="3"/>
          <float name="repeatV" value="3"/>
          <rgb name="warp_kd" value="0.7 0.1 0.2"/>
        </bsdf>
      </shape>
      <emitter type="point">
        <point name="position" x="0" y="0" z="-2"/>
        <rgb name="intensity" value="1 1 1"/>
      </emitter>
    </scene>"""
    (desc, _), (jdesc, _) = both(xml)
    b = desc["shapes"][0]["bsdf"]
    assert b["type"] == "irawan" and b["filename"] == str(wf)
    scene = compiled_equal(desc, jdesc)
    packed = scene.mats.packed.numpy()
    rows = np.where(packed[:, 0] == int(BSDFType.CLOTH))[0]
    assert rows.size == 1
    np.testing.assert_allclose(packed[int(rows[0]), 25:27], [3.0, 3.0])


def test_bsdf_fixture_list_matches():
    """load_bsdfs_xml (a bare list of <bsdf>, as the chi-square fixtures
    are) gives JAX's list, strict and permissive."""
    xml = """<scene version="0.5.0">
      <bsdf type="diffuse"/>
      <bsdf type="roughdiffuse"><float name="alpha" value="0.4"/></bsdf>
      <bsdf type="mixturebsdf"><string name="weights" value="0.3 0.7"/>
        <bsdf type="diffuse"/><bsdf type="conductor"/></bsdf>
      <bsdf type="weird"/>
    </scene>"""
    with pytest.warns(UserWarning, match="weird"):
        got = load_bsdfs_xml(xml, strict=False)
    with pytest.warns(UserWarning):
        want = j_load_bsdfs_xml(xml, strict=False)
    assert_same(got, want)
    assert len(got) == 4 and len(got[2]["bsdfs"]) == 2
    with pytest.raises(ValueError, match="weird"):
        load_bsdfs_xml(xml)


# --- one XML per shape, BSDF, emitter, sensor, medium, transform, $key -------

LIGHT = """<shape type="rectangle"><transform name="toWorld"><rotate x="1" angle="90"/>
  <translate y="2"/></transform><bsdf type="diffuse"/>
  <emitter type="area"><rgb name="radiance" value="4 3 2"/></emitter></shape>"""
CAMERA = """<sensor type="perspective"><float name="fov" value="50"/>
  <transform name="toWorld"><lookat origin="0, 1, -4" target="0, 0.5, 0"/></transform>
  <film type="hdrfilm"><integer name="width" value="24"/><integer name="height" value="20"/></film>
  <sampler type="independent"><integer name="sampleCount" value="8"/></sampler></sensor>"""


def _scene(body, light=True, camera=True):
    return (f'<scene version="0.6.0">{CAMERA if camera else ""}{body}'
            f'{LIGHT if light else ""}</scene>')


def _shape(bsdf, kind="rectangle"):
    return f'<shape type="{kind}">{bsdf}</shape>'


def _write_files(d):
    """The mesh, image and volume files the cases name, under ``d``."""
    from mitsuba_path_guiding_torch.film.film import write_image
    from mitsuba_path_guiding_torch.scene.shapes import make_sphere, save_serialized

    mesh = make_sphere(6, 12)
    with open(d / "m.obj", "w") as f:
        for v in mesh.vertices:
            f.write("v " + " ".join(repr(float(x)) for x in v) + "\n")
        for a, b, c in mesh.faces + 1:
            f.write(f"f {a} {b} {c}\n")
    v = mesh.vertices
    head = ("ply\nformat ascii 1.0\nelement vertex %d\nproperty double x\nproperty double y\n"
            "property double z\nelement face %d\nproperty list uchar int vertex_indices\n"
            "end_header\n" % (len(v), len(mesh.faces)))
    with open(d / "m.ply", "w") as f:
        f.write(head + "".join(" ".join(repr(float(x)) for x in p) + "\n" for p in v)
                + "".join(f"3 {a} {b} {c}\n" for a, b, c in mesh.faces))
    save_serialized(str(d / "m.serialized"), [mesh])
    rs = np.random.default_rng(3)
    np.save(d / "h.npy", rs.random((9, 11)))
    with open(d / "f.hair", "w") as f:
        f.write("0 0 0\n0 0.5 0.1\n0 1 0\n\n0.2 0 0\n0.25 0.6 0\n")
    write_image(str(d / "env.pfm"), (0.5 + rs.random((8, 16, 3))).astype(np.float32))


def _bsdf_case(t):
    inner = {
        "roughdiffuse": '<float name="alpha" value="0.3"/>',
        "conductor": '<string name="material" value="Au"/>',
        "roughconductor": '<float name="alpha" value="0.2"/><rgb name="eta" value="0.2 0.9 1.1"/>'
                          '<rgb name="k" value="3.9 2.4 2.1"/>',
        "dielectric": '<float name="intIOR" value="1.33"/>',
        "thindielectric": '<float name="int_ior" value="1.5"/><float name="extIOR" value="1.0"/>',
        "roughdielectric": '<float name="alpha" value="0.15"/>',
        "plastic": '<srgb name="diffuseReflectance" value="0.2, 0.4, 0.6"/>',
        "roughplastic": '<float name="alpha" value="0.1"/>'
                        '<spectrum name="specularReflectance" value="0.9"/>',
        "phong": '<float name="exponent" value="30"/>',
        "twosided": '<bsdf type="diffuse"><rgb name="reflectance" value="0.1 0.2 0.3"/></bsdf>',
        "mask": '<rgb name="opacity" value="0.3 0.3 0.3"/><bsdf type="diffuse"/>',
        "bumpmap": '<texture type="checkerboard"><float name="uscale" value="4"/></texture>'
                   '<float name="scale" value="2"/><bsdf type="roughplastic"/>',
        "normalmap": '<texture type="checkerboard"><rgb name="color0" value="0.5 0.5 1"/>'
                     '</texture><bsdf type="diffuse"/>',
        "coating": '<float name="thickness" value="0.5"/><rgb name="sigmaA" value="0.1 0.2 0.3"/>'
                   '<bsdf type="roughconductor"/>',
        "ward": '<float name="alpha" value="0.2"/>',
        "mixturebsdf": '<string name="weights" value="0.25, 0.75"/><bsdf type="diffuse"/>'
                       '<bsdf type="dielectric"/>',
        "blendbsdf": '<float name="weight" value="0.3"/><bsdf type="diffuse"/>'
                     '<bsdf type="conductor"/>',
        "difftrans": '<rgb name="reflectance" value="0.4 0.5 0.6"/>',
        "diffuse": '<texture type="checkerboard" name="reflectance">'
                   '<rgb name="color1" value="0.8 0.1 0.1"/></texture>',
        "irawan": '<float name="repeatU" value="2"/><float name="repeatV" value="4"/>',
    }.get(t, "")
    return _scene(_shape(f'<bsdf type="{t}">{inner}</bsdf>'))


CASES = {f"bsdf_{t}": (lambda t=t: lambda d: _bsdf_case(t))() for t in sorted(_SUPPORTED_BSDFS)}
CASES.update({
    "shape_rectangle": lambda d: _scene(_shape('<bsdf type="diffuse"/>')),
    "shape_cube": lambda d: _scene('<shape type="cube"><boolean name="flipNormals" value="true"/>'
                                   '<transform name="toWorld"><scale x="0.5" y="0.2" z="0.3"/>'
                                   '</transform></shape>'),
    "shape_sphere": lambda d: _scene('<shape type="sphere"><point name="center" x="0.1" y="0.5"'
                                     ' z="0.2"/><float name="radius" value="0.4"/></shape>'),
    "shape_disk": lambda d: _scene('<shape type="disk"><transform name="toWorld">'
                                   '<rotate x="1" angle="-90"/></transform></shape>'),
    "shape_cylinder": lambda d: _scene('<shape type="cylinder"/>'),
    "shape_obj": lambda d: _scene('<shape type="obj"><string name="filename" value="m.obj"/>'
                                  '</shape>'),
    "shape_ply": lambda d: _scene('<shape type="ply"><string name="filename" value="m.ply"/>'
                                  '<transform name="toWorld"><translate x="0.3"/></transform>'
                                  '</shape>'),
    "shape_serialized": lambda d: _scene('<shape type="serialized"><string name="filename" '
                                         'value="m.serialized"/></shape>'),
    "shape_heightfield": lambda d: _scene('<shape type="heightfield"><string name="filename" '
                                          'value="h.npy"/></shape>'),
    "shape_hair": lambda d: _scene('<shape type="hair"><string name="filename" value="f.hair"/>'
                                   '</shape>'),
    "emitter_constant": lambda d: _scene(_shape("") + '<emitter type="constant">'
                                         '<rgb name="radiance" value="0.5 0.6 0.7"/></emitter>',
                                         light=False),
    "emitter_point": lambda d: _scene(_shape("") + '<emitter type="point"><point '
                                      'name="position" x="0" y="1" z="0"/><spectrum '
                                      'name="intensity" value="3"/></emitter>', light=False),
    "emitter_point_to_world": lambda d: _scene(_shape("") + '<emitter type="point"><transform '
                                               'name="toWorld"><translate y="1.5"/></transform>'
                                               '</emitter>', light=False),
    "emitter_directional": lambda d: _scene(_shape("") + '<emitter type="directional"><vector '
                                            'name="direction" x="0" y="-1" z="0.2"/><rgb '
                                            'name="irradiance" value="2 2 2"/></emitter>'),
    "emitter_spot": lambda d: _scene(_shape("") + '<emitter type="spot"><float name="cutoffAngle"'
                                     ' value="25"/><transform name="toWorld"><lookat origin="0 2 0"'
                                     ' target="0 0 0" up="0 0 1"/></transform></emitter>'),
    "emitter_envmap": lambda d: _scene(_shape("") + '<emitter type="envmap"><string '
                                       'name="filename" value="env.pfm"/><float name="scale" '
                                       'value="0.5"/></emitter>', light=False),
    "emitter_sky": lambda d: _scene(_shape("") + '<emitter type="sky"><float name="turbidity" '
                                    'value="3"/><integer name="resolution" value="32"/></emitter>',
                                    light=False),
    "emitter_sun": lambda d: _scene(_shape("") + '<emitter type="sun"><vector '
                                    'name="sunDirection" x="0.3" y="0.8" z="0.1"/><float '
                                    'name="sunScale" value="0.5"/></emitter>', light=False),
    "emitter_collimated": lambda d: _scene(_shape("") + '<emitter type="collimated"><rgb '
                                           'name="power" value="2 2 2"/></emitter>'),
    "sensor_thinlens": lambda d: _scene(_shape("") + '<sensor type="thinlens"><float '
                                        'name="apertureRadius" value="0.05"/><float '
                                        'name="focusDistance" value="3"/></sensor>',
                                        camera=False),
    "sensor_orthographic": lambda d: _scene(_shape("") + '<sensor type="orthographic">'
                                            '<transform name="toWorld"><lookAt origin="0 0 -3" '
                                            'target="0 0 0"/></transform></sensor>', camera=False),
    "sensor_in_shape": lambda d: _scene('<shape type="disk"><transform name="toWorld"><translate'
                                        ' z="-1"/></transform><sensor type="irradiancemeter"/>'
                                        '</shape>', camera=False),
    "medium_hg": lambda d: _scene(_shape("") + '<medium type="homogeneous"><rgb name="sigmaA" '
                                  'value="0.1 0.1 0.1"/><rgb name="sigmaS" value="0.5 0.4 0.3"/>'
                                  '<phase type="hg"><float name="g" value="0.6"/></phase></medium>'),
    "medium_rayleigh": lambda d: _scene(_shape("") + '<medium type="homogeneous"><rgb '
                                        'name="sigma_s" value="0.3 0.3 0.3"/><phase '
                                        'type="rayleigh"/></medium>'),
    "medium_mixture": lambda d: _scene(_shape("") + '<medium type="homogeneous"><rgb '
                                       'name="sigmaS" value="0.3 0.3 0.3"/><phase '
                                       'type="mixturephase"><string name="weights" '
                                       'value="0.3, 0.7"/><phase type="hg"><float name="g" '
                                       'value="0.5"/></phase><phase type="isotropic"/></phase>'
                                       '</medium>'),
    "transform_stack": lambda d: _scene('<shape type="cube"><transform name="toWorld"><scale '
                                        'value="0.3"/><rotate y="1" angle="33"/><translate x="0.1"'
                                        ' y="0.4"/><matrix value="1 0 0 0.1 0 1 0 0 0 0 1 0.2 0 0'
                                        ' 0 1"/><scale x="1" y="2" z="1"/></transform></shape>'),
    "defaults_and_defines": lambda d: (
        '<scene version="0.6.0"><default name="r" value="0.25"/><default name="spp" value="4"/>'
        + CAMERA.replace('value="8"', 'value="$spp"')
        + '<shape type="sphere"><float name="radius" value="$r"/><bsdf type="diffuse"><rgb '
          'name="reflectance" value="$alb"/></bsdf></shape>' + LIGHT + '</scene>'),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_xml_case_loads_and_compiles_as_jax(case, tmp_path):
    """The case's XML file loads to JAX's dict and settings and compiles
    to JAX's arrays."""
    _write_files(tmp_path)
    path = tmp_path / "scene.xml"
    path.write_text(CASES[case](tmp_path))
    defines = {"alb": "0.3 0.5 0.7"} if case == "defaults_and_defines" else None
    (desc, settings), (jdesc, _) = both(str(path), defaults=defines)
    if case == "defaults_and_defines":
        assert settings["spp"] == 4 and desc["shapes"][0]["radius"] == 0.25
        assert desc["shapes"][0]["bsdf"]["reflectance"] == [0.3, 0.5, 0.7]
    compiled_equal(desc, jdesc)


def test_cases_cover_every_shape_and_bsdf():
    assert {f"shape_{s}" for s in _SHAPES} <= set(CASES)
    assert {f"bsdf_{b}" for b in _SUPPORTED_BSDFS} <= set(CASES)


def test_matrix_cornell_compiles_and_renders_as_builtin(tmp_path):
    """chip_smoke's scene_xml writes the Cornell box with <matrix>
    transforms: it compiles equal to the built-in and its 16x16 render
    equals the built-in's bit for bit."""
    from chip_smoke import scene_differences, scene_xml

    settings = {"width": 16, "height": 16, "spp": 4, "max_depth": 5, "rr_depth": 5}
    path = scene_xml(tscenes.cornell_box(), str(tmp_path), "cornell", settings)
    desc, got_settings = load_scene_xml(path)
    assert {k: got_settings[k] for k in settings} == settings
    xml_scene = build_scene(desc, device="cpu")
    builtin = build_scene(tscenes.cornell_box(), device="cpu")
    assert scene_differences(xml_scene, builtin) == []
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=5)
    assert torch.equal(render(xml_scene, cfg), render(builtin, cfg))
    assert os.path.exists(path)
