"""Scene compiler: dict scene description -> flat SceneData tensors.

Port of the reference's scene/builder.py ``build_scene``: triangle shapes
(with shape groups and instances flattened), the analytic BSDF families
(``blendbsdf``, ``mixturebsdf``, ``mask``, ``coating`` and
``roughcoating`` with one level of nested rows, interned before their
parent as the reference does, and ``hk``), ``irawan`` woven cloth (its
weave tile baked into a kd texture and a yarn-record texture,
``models/cloth.py``), the ``bumpmap`` and ``normalmap`` wrappers (a
height map becomes a normal map on the host), reflectance textures
(``bitmap`` from an inline ``image`` or a ``filename``, ``scale``,
``checkerboard``, ``gridtexture``, ``vertexcolors``, ``curvature`` and
``wireframe``) in one atlas with mip levels (``models/texture.py``), the
coat transmittance tables, ``area`` emitters on shapes, the
``constant``, ``envmap`` (an inline ``image`` or a ``filename``),
``point``, ``directional``, ``spot``, ``collimated``, ``sky``, ``sun``
and ``sunsky`` emitters, and every sensor kind of the reference
(perspective, thin lens and radially distorted perspective,
orthographic, spherical, telecentric and the three measurement probes),
and participating media (homogeneous or grid, every phase family of
``models/phase.py``).  Every scene carries its BVH (built by the native
builder, so a compile needs g++; its depth is checked against the
traversal stack); from 16384 triangles on it also carries the blocklist
and pair tables of the big-scene intersectors.  The arrays are computed
host-side in numpy with the reference's exact arithmetic, so a compiled
scene is equal to the JAX build array for array.  Subsurface scattering
raises ``NotImplementedError`` naming the ROADMAP item that brings it.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
from mitsuba_path_guiding_torch.accel.bvh import build_bvh, pack_bvh, to_device
from mitsuba_path_guiding_torch.accel.pairs import build_pair_table
from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.core.spectrum import LUM_WEIGHTS_NP
from mitsuba_path_guiding_torch.models.cloth import PLAIN_WEAVE, compile_cloth, parse_weave
from mitsuba_path_guiding_torch.models.envmap import build_env_tables, constant_env_tables
from mitsuba_path_guiding_torch.models.microfacet_tables import N_COS, coat_transmittance_table
from mitsuba_path_guiding_torch.models.phase import (
    MIX_HG,
    MIX_RAYLEIGH,
    PhaseKind,
    kkay_normalization,
    microflake_tables,
)
from mitsuba_path_guiding_torch.models.sunsky import (
    hosek_sky_image,
    preetham_sky_image,
    preetham_sun_irradiance,
    sun_direction_from_angles,
)
from mitsuba_path_guiding_torch.models.texture import build_atlas_np, rasterize_procedural
from mitsuba_path_guiding_torch.ops.intersect_bvh import STACK_SIZE
from mitsuba_path_guiding_torch.scene.shapes import SHAPE_BUILDERS, curvature_colors
from mitsuba_path_guiding_torch.scene.transforms import look_at, scale, translate
from mitsuba_path_guiding_torch.scene.types import (
    BSDFType,
    Emitters,
    EmitterKind,
    Geometry,
    Materials,
    MediumData,
    SceneData,
    Sensor,
    SensorKind,
)
from mitsuba_path_guiding_torch.scene.volume import load_volume_spec
from mitsuba_path_guiding_torch.util import _read

# From this triangle count on, the scene carries the pair and blocklist
# tables of the big-scene intersectors, as in the reference.
TWOLEVEL_MIN_TRIS = 16384

_BSDF_TYPES = {
    "diffuse": BSDFType.DIFFUSE,
    "roughdiffuse": BSDFType.ROUGH_DIFFUSE,
    "conductor": BSDFType.CONDUCTOR,
    "dielectric": BSDFType.DIELECTRIC,
    "thindielectric": BSDFType.THINDIELECTRIC,
    "roughconductor": BSDFType.ROUGH_CONDUCTOR,
    "roughdielectric": BSDFType.ROUGH_DIELECTRIC,
    "plastic": BSDFType.PLASTIC,
    "roughplastic": BSDFType.ROUGH_PLASTIC,
    "phong": BSDFType.PHONG,
    "null": BSDFType.NULL,
    "ward": BSDFType.WARD,
    "difftrans": BSDFType.DIFFTRANS,
    "hk": BSDFType.HK,
    # nested wrappers, one level deep
    "blendbsdf": BSDFType.BLEND,
    "mixturebsdf": BSDFType.BLEND,
    "mask": BSDFType.MASK,
    "coating": BSDFType.COATING,
    # a COATING row with alpha > 0: a GGX lobe off the coat interface
    "roughcoating": BSDFType.COATING,
}
# named conductor IOR presets (the reference's, RGB-averaged)
_CONDUCTOR_IOR = {
    "Au": ([0.143, 0.375, 1.442], [3.983, 2.386, 1.603]),
    "Ag": ([0.155, 0.116, 0.138], [4.828, 3.122, 2.146]),
    "Al": ([1.345, 0.965, 0.617], [7.475, 6.400, 5.303]),
    "Cu": ([0.201, 0.924, 1.102], [3.910, 2.448, 2.168]),
    "none": ([0.0, 0.0, 0.0], [1.0, 1.0, 1.0]),  # perfect mirror
}


_SENSOR_KINDS = {
    "perspective": SensorKind.PERSPECTIVE,
    "thinlens": SensorKind.PERSPECTIVE,
    "perspective_rdist": SensorKind.PERSPECTIVE,
    "orthographic": SensorKind.ORTHOGRAPHIC,
    "spherical": SensorKind.SPHERICAL,
    "telecentric": SensorKind.TELECENTRIC,
    "irradiancemeter": SensorKind.IRRADIANCEMETER,
    "radiancemeter": SensorKind.RADIANCEMETER,
    "fluencemeter": SensorKind.FLUENCEMETER,
}


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP {item}")


def _rgb(x, default):
    if x is None:
        return np.array(default, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    return np.full(3, float(x)) if x.ndim == 0 else x


def _compile_bsdf(spec: dict, textures: list | None = None, register_sub=None) -> dict:
    """One material row.  A ``texture`` sub-dict rasterizes into
    ``textures`` (the scene's atlas images) and overrides the reflectance
    at shading time; ``vertexcolors`` and ``curvature`` select the
    per-vertex colour table (id -3), ``wireframe`` the edge colour by
    barycentric distance (id -4).  The nested wrappers (``blendbsdf``,
    ``mixturebsdf``, ``mask``, ``coating``, ``roughcoating``) register
    their child lobes through ``register_sub`` (a callable returning the
    child's row index) and store the indices in sub_a / sub_b; a wrapper
    inside a wrapper raises, as in the reference.  ``bumpmap`` and
    ``normalmap`` compile to their child's row plus the bump fields;
    ``irawan`` to a CLOTH row (columns as in ``scene/types.py``) with its
    kd texture and, in the bump slot, its yarn-record texture."""
    t = spec.get("type", "diffuse")
    if t == "irawan":
        if register_sub is None:
            raise ValueError("irawan may not be nested inside another wrapper")
        if "filename" in spec:
            with open(spec["filename"]) as fh:
                text = fh.read()
        else:
            text = spec.get("weave", PLAIN_WEAVE)
        # the other plugin properties resolve $identifier placeholders in
        # the pattern
        reserved = {"type", "filename", "weave", "repeatU", "repeatV"}
        params = {k: v for k, v in spec.items() if k not in reserved}
        wp = parse_weave(text, params or None)
        cc = compile_cloth(wp)
        row = {
            "type": int(BSDFType.CLOTH),
            "reflectance": np.asarray(np.mean([y["kd"] for y in wp["yarns"]], axis=0),
                                      np.float32),
            "specular": np.asarray(cc["mean_ks"], np.float32),
            "eta": np.asarray([cc["alpha"], cc["beta"], cc["ss"]], np.float32),
            "k": np.asarray([cc["psi"], cc["umax"], cc["kappa"]], np.float32),
            "alpha": cc["a_fb"],
            "alpha_v": cc["norm"],
            "weight": cc["h_width"],
            "texture_id": -1,
            "cloth_extra": (cc["w"], cc["l"], cc["area_warp"], cc["area_weft"],
                            cc["fb_scale"]),
        }
        if textures is not None:
            textures.append(cc["kd_img"])
            row["texture_id"] = len(textures) - 1
            # the yarn-record map rides the bump slot (fetched nearest,
            # never a normal perturbation: the tracer skips CLOTH rows)
            textures.append(cc["aux_img"])
            row["bump_tex_id"] = len(textures) - 1
        row["uv_scale"] = (float(spec.get("repeatU", 1.0)), float(spec.get("repeatV", 1.0)))
        return row
    if t in ("bumpmap", "normalmap"):
        if register_sub is None:
            raise ValueError(f"{t} not allowed here")
        inner = dict(spec.get("bsdf") or {"type": "diffuse"})
        row = _compile_bsdf(inner, textures, register_sub)
        row["bump_tex_id"], row["bump_scale"] = _compile_bump_texture(
            spec, textures, is_height=(t == "bumpmap"))
        return row
    if t not in _BSDF_TYPES:
        raise ValueError(f"unknown bsdf type: {t}")
    row = {
        "type": _BSDF_TYPES[t],
        "reflectance": _rgb(spec.get("reflectance", spec.get("diffuse_reflectance")), [0.5, 0.5, 0.5]),
        "specular": _rgb(spec.get("specular_reflectance"), [1.0, 1.0, 1.0]),
        "eta": _rgb(spec.get("eta"), [1.5, 1.5, 1.5]),
        "k": _rgb(spec.get("k"), [0.0, 0.0, 0.0]),
        "alpha": float(spec.get("alpha", spec.get("alpha_u", 0.1))),
        "alpha_v": float(spec.get("alpha_v", spec.get("alpha", spec.get("alpha_u", 0.1)))),
        "texture_id": -1,
        "sub_a": -1,
        "sub_b": -1,
        "weight": 0.0,
        "bump_tex_id": -1,
        "bump_scale": 1.0,
    }
    if t in ("coating", "roughcoating"):
        if register_sub is None:
            raise ValueError(f"{t} may not be nested inside another wrapper")
        row["eta"] = np.full(3, float(spec.get("int_ior", 1.5046))
                             / float(spec.get("ext_ior", 1.000277)))
        # coat interface roughness: 0 is a delta reflection (coating), > 0
        # a GGX reflection lobe (roughcoating)
        row["alpha"] = float(spec.get("alpha", 0.1)) if t == "roughcoating" else 0.0
        row["weight"] = float(spec.get("thickness", 1.0))
        row["reflectance"] = _rgb(spec.get("sigma_a"), [0.0, 0.0, 0.0])
        row["sub_a"] = register_sub(spec.get("bsdf") or {"type": "diffuse"})
        return row
    if t == "hk":
        # Hanrahan-Krueger slab: sigma_s/sigma_a (or sigma_t and albedo),
        # thickness and the HG g, packed as refl = sigma_s, k = sigma_a,
        # weight = thickness, eta = g (models/bsdf.py _hk_params)
        ss, sa = spec.get("sigma_s"), spec.get("sigma_a")
        if "sigma_t" in spec:
            st = _rgb(spec["sigma_t"], [1.0] * 3)
            al = _rgb(spec.get("albedo"), [0.8] * 3)
            ss, sa = st * al, st * (1.0 - al)
        row["reflectance"] = _rgb(ss, [1.0] * 3)
        row["k"] = _rgb(sa, [0.05] * 3)
        row["weight"] = float(spec.get("thickness", 1.0))
        row["eta"] = np.full(3, float(spec.get("g", 0.0)))
        return row
    if t in ("blendbsdf", "mixturebsdf", "mask"):
        if register_sub is None:
            raise ValueError(f"{t} may not be nested inside another wrapper")
        if t == "mask":
            op = _rgb(spec.get("opacity"), [0.5] * 3)
            row["weight"] = float(np.mean(op))
            row["sub_a"] = register_sub(spec.get("bsdf") or {"type": "diffuse"})
        else:
            subs = spec.get("bsdfs")
            if t == "mixturebsdf":
                weights = [float(x) for x in spec.get("weights", [0.5, 0.5])]
                if len(subs) != 2:
                    raise ValueError("mixturebsdf: exactly 2 components are supported")
                wsum = max(weights[0] + weights[1], 1e-9)
                row["weight"] = weights[1] / wsum
            else:
                row["weight"] = float(spec.get("weight", 0.5))
            row["sub_a"] = register_sub(subs[0])
            row["sub_b"] = register_sub(subs[1])
        return row
    tex = spec.get("texture")
    if tex is not None and textures is not None:
        tt = tex.get("type", "bitmap")
        if tt in ("vertexcolors", "curvature"):
            # the colours come from the per-vertex table of the shape loop
            row["texture_id"] = -3
        elif tt == "wireframe":
            # the line width is a barycentric fraction, not a world width
            row["texture_id"] = -4
            row["reflectance"] = _rgb(tex.get("interior_color", tex.get("interiorColor")),
                                      [0.5] * 3)
            row["wire_edge"] = _rgb(tex.get("edge_color", tex.get("edgeColor")), [0.1] * 3)
            row["wire_lw"] = float(tex.get("line_width", tex.get("lineWidth", 0.05)))
        else:
            img = _rasterize_texture(tex, textures)
            textures.append(img)
            row["texture_id"] = len(textures) - 1
    if t in ("conductor", "roughconductor"):
        mat = spec.get("material", None)
        if mat is not None or "eta" not in spec:
            eta, k = _CONDUCTOR_IOR[mat or "none"]
            row["eta"], row["k"] = np.array(eta), np.array(k)
    if t in ("dielectric", "thindielectric", "roughdielectric", "plastic", "roughplastic"):
        int_ior = float(spec.get("int_ior", 1.5046))
        ext_ior = float(spec.get("ext_ior", 1.000277))
        row["eta"] = np.full(3, int_ior / ext_ior)
    return row


def _rasterize_texture(tex: dict, textures: list) -> np.ndarray:
    """A texture sub-dict as an image: ``bitmap`` (an inline ``image`` or
    a ``filename`` read by ``util._read``), ``scale`` (an inner texture, or
    1, times a scalar or RGB factor) or a procedural pattern."""
    tt = tex.get("type", "bitmap")
    if tt == "bitmap":
        if "image" in tex:
            return np.asarray(tex["image"], dtype=np.float32)
        return _read(tex["filename"])
    if tt == "scale":
        inner = tex.get("texture")
        img = (_rasterize_texture(inner, textures) if inner is not None
               else np.ones((1, 1, 3), np.float32))
        return (img * _rgb(tex.get("scale"), [1.0] * 3)).astype(np.float32)
    return rasterize_procedural(tex)


def _compile_bump_texture(spec: dict, textures: list | None, is_height: bool):
    """The ``bumpmap`` / ``normalmap`` texture: (atlas id, scale).  A
    height map becomes a tangent-space normal map here (finite
    differences), so shading has one path: a normal-map fetch and a frame
    perturbation."""
    tex = spec.get("texture")
    if tex is None or textures is None:
        return -1, 1.0
    img = _rasterize_texture(tex, textures)
    scale_f = float(spec.get("scale", 1.0))
    if is_height:
        h = img.mean(axis=-1) if img.ndim == 3 else img
        gy, gx = np.gradient(h)
        H, W = h.shape
        n = np.stack([-scale_f * gx * W, -scale_f * gy * H, np.ones_like(h)], axis=-1)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        img = ((n + 1.0) * 0.5).astype(np.float32)
    textures.append(np.asarray(img, dtype=np.float32))
    return len(textures) - 1, scale_f


def _to_world(spec):
    m = spec.get("to_world", None)
    if m is None:
        m = np.eye(4)
        if "center" in spec or "radius" in spec:
            r = float(spec.get("radius", 1.0))
            c = spec.get("center", [0.0, 0.0, 0.0])
            m = translate(*c) @ scale(r)
    return np.asarray(m, dtype=np.float64)


def _compile_medium(med: dict | None, t) -> MediumData:
    """Medium dict -> MediumData, as the reference compiles it; ``t``
    makes a tensor on the scene's device.

    Homogeneous: {"sigma_a": rgb, "sigma_s": rgb, "g": float}, with
    "scale" multiplying both and "phase" one of "hg" (the default),
    "isotropic", "rayleigh", "kkay" ("orientation", "ks", "kd",
    "exponent"), "microflake" ("orientation", "stddev") or "mixture"
    ("phase_components" of {"type": "hg" | "isotropic" | "rayleigh",
    "g": float}, "phase_weights").  A grid medium adds "density", a volume
    spec of ``scene/volume.py`` ``load_volume_spec``, and optionally
    "bounds", its world AABB."""
    ones = np.ones((1, 1, 1), dtype=np.float32)
    eye = np.eye(4, dtype=np.float32)
    if med is None:
        return MediumData(
            sigma_a=t(np.zeros(3, np.float32)), sigma_s=t(np.zeros(3, np.float32)),
            phase_g=t(np.float32(0.0)), enabled=False, density=t(ones),
            world_to_grid=t(eye), majorant=t(np.float32(0.0)), heterogeneous=False,
            phase_kind=0)
    scale_f = float(med.get("scale", 1.0))
    sigma_a = np.asarray(med.get("sigma_a", [0.0] * 3), dtype=np.float32) * scale_f
    sigma_s = np.asarray(med.get("sigma_s", [0.0] * 3), dtype=np.float32) * scale_f
    phase_name = med.get("phase", "hg")
    pk = {
        "rayleigh": PhaseKind.RAYLEIGH,
        "kkay": PhaseKind.KKAY,
        "microflake": PhaseKind.MICROFLAKE,
        "mixture": PhaseKind.MIXTURE,
        "mixturephase": PhaseKind.MIXTURE,
    }.get(phase_name, PhaseKind.HG)
    g = 0.0 if phase_name in ("isotropic", "rayleigh") else float(med.get("g", 0.0))
    extra = {}
    if pk == PhaseKind.MIXTURE:
        comps = med.get("phase_components", [])
        ws = np.asarray(med.get("phase_weights", [1.0] * len(comps)), dtype=np.float32)
        if len(comps) == 0 or len(ws) != len(comps):
            raise ValueError("mixture phase needs matching weights/components")
        if np.any(ws < 0.0) or ws.sum() <= 0.0:
            raise ValueError("invalid mixture phase weights")
        ws = ws / ws.sum()
        gs, kinds = [], []
        for c in comps:
            ct = c.get("type", "hg") if isinstance(c, dict) else str(c)
            if ct == "rayleigh":
                gs.append(0.0)
                kinds.append(MIX_RAYLEIGH)
            elif ct == "isotropic":
                gs.append(0.0)
                kinds.append(MIX_HG)
            elif ct == "hg":
                gs.append(float(c.get("g", 0.0)) if isinstance(c, dict) else 0.0)
                kinds.append(MIX_HG)
            else:
                raise ValueError(f"unsupported mixture phase component '{ct}'")
        extra["mix_weights"] = t(ws)
        extra["mix_g"] = t(np.asarray(gs, dtype=np.float32))
        extra["mix_kinds"] = t(np.asarray(kinds, dtype=np.int32), torch.int32)
    if pk in (PhaseKind.KKAY, PhaseKind.MICROFLAKE):
        axis = np.asarray(med.get("orientation", [0.0, 0.0, 1.0]), dtype=np.float32)
        axis = axis / max(np.linalg.norm(axis), 1e-9)
        extra["orientation"] = t(axis)
        if pk == PhaseKind.KKAY:
            e = float(med.get("exponent", 4.0))
            extra["phase_aux"] = t(np.array(
                [float(med.get("ks", 0.4)), float(med.get("kd", 0.2)), e, kkay_normalization(e)],
                dtype=np.float32))
        else:
            aux, table = microflake_tables(float(med.get("stddev", 0.3)))
            extra["phase_aux"] = t(aux)
            extra["sigt_table"] = t(table)
    dens_spec = med.get("density", None)
    if dens_spec is None:
        return MediumData(
            sigma_a=t(sigma_a), sigma_s=t(sigma_s), phase_g=t(np.float32(g)), enabled=True,
            density=t(ones), world_to_grid=t(eye),
            majorant=t(np.float32(np.max(sigma_a + sigma_s))), heterogeneous=False,
            phase_kind=pk, **extra)
    grid, aabb = load_volume_spec(dens_spec)
    if "bounds" in med:
        aabb = np.asarray(med["bounds"], dtype=np.float32).reshape(2, 3)
    if aabb is None:
        aabb = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], dtype=np.float32)
    lo, hi = aabb[0], aabb[1]
    extent = np.maximum(hi - lo, 1e-8)
    w2g = np.eye(4, dtype=np.float32)
    w2g[:3, :3] = np.diag(1.0 / extent)
    w2g[:3, 3] = -lo / extent
    majorant = float(grid.max()) * float(np.max(sigma_a + sigma_s))
    return MediumData(
        sigma_a=t(sigma_a), sigma_s=t(sigma_s), phase_g=t(np.float32(g)), enabled=True,
        density=t(grid.astype(np.float32)), world_to_grid=t(w2g),
        majorant=t(np.float32(majorant)), heterogeneous=True, phase_kind=pk, **extra)


def _compile_emitters(especs, add_emitter):
    """The scene-level emitters, appended through ``add_emitter``.  Returns
    (env_id, env_kind, env_tables): the environment emitter's row (-1
    without one; the last one listed wins, as in the reference), its kind
    and, for an ``envmap``, its tables."""
    env_id, env_kind, env_tables = -1, None, None
    lum = lambda rgb: float(np.dot(rgb, LUM_WEIGHTS_NP))  # noqa: E731
    for espec in especs:
        t = espec["type"]
        if t == "envmap":
            img = (np.asarray(espec["image"], dtype=np.float32) if "image" in espec
                   else _read(espec["filename"]))
            sc_f = float(espec.get("scale", 1.0))
            env_tables = build_env_tables(img, sc_f)
            mean_lum = float((img @ LUM_WEIGHTS_NP).mean()) * sc_f
            env_id = add_emitter(EmitterKind.ENVMAP, [mean_lum] * 3, power=mean_lum * 4 * np.pi)
            env_kind = EmitterKind.ENVMAP
        elif t == "constant":
            rad = _rgb(espec.get("radiance"), [1.0, 1.0, 1.0])
            env_id = add_emitter(EmitterKind.CONSTANT, rad, power=lum(rad) * 4 * np.pi)
            env_kind = EmitterKind.CONSTANT
        elif t == "point":
            inten = _rgb(espec.get("intensity"), [1.0, 1.0, 1.0])
            pos = np.asarray(espec.get("position", _to_world(espec)[:3, 3]), dtype=np.float64)
            add_emitter(EmitterKind.POINT, inten, position=pos, power=lum(inten) * 4 * np.pi)
        elif t == "directional":
            irr = _rgb(espec.get("irradiance"), [1.0, 1.0, 1.0])
            d = np.asarray(espec["direction"], dtype=np.float64)
            d = d / np.linalg.norm(d)
            add_emitter(EmitterKind.DIRECTIONAL, irr, position=d, power=lum(irr))
        elif t == "collimated":
            # a delta beam along one ray: NEE never reaches it
            pw = _rgb(espec.get("power"), [1.0, 1.0, 1.0])
            tw = _to_world(espec)
            pos = np.asarray(espec.get("position", tw[:3, 3]), dtype=np.float64)
            axis = np.asarray(espec["direction"], dtype=np.float64) if "direction" in espec \
                else tw[:3, 2]
            axis = axis / np.linalg.norm(axis)
            add_emitter(EmitterKind.COLLIMATED, pw, position=pos, aux=axis, power=lum(pw))
        elif t == "spot":
            inten = _rgb(espec.get("intensity"), [1.0, 1.0, 1.0])
            tw = _to_world(espec)
            axis = tw[:3, 2] / np.linalg.norm(tw[:3, 2])
            cut_deg = float(espec.get("cutoff_angle", 20.0))
            cutoff = np.cos(np.deg2rad(cut_deg))
            beam = np.cos(np.deg2rad(float(espec.get("beam_width", cut_deg * 0.75))))
            add_emitter(EmitterKind.SPOT, inten, position=tw[:3, 3], aux=axis,
                        cutoff=(cutoff, beam),
                        power=lum(inten) * 2 * np.pi * (1 - cutoff))
        elif t in ("sky", "sun", "sunsky"):
            # the clear sky becomes an importance-sampled envmap, the sun a
            # directional delta light (models/sunsky.py)
            if "sun_direction" in espec:
                sdir = np.asarray(espec["sun_direction"], dtype=np.float64)
                sdir = sdir / np.linalg.norm(sdir)
            else:
                sdir = sun_direction_from_angles(float(espec.get("elevation", 30.0)),
                                                 float(espec.get("azimuth", 0.0)))
            turb = float(espec.get("turbidity", 3.0))
            sc_f = float(espec.get("scale", 1.0))
            if t in ("sky", "sunsky"):
                if env_id >= 0:
                    raise ValueError("only one environment emitter allowed")
                # Hosek-Wilkie 2012 by default, Preetham 1999 with
                # model="preetham"
                sky_fn = (preetham_sky_image
                          if str(espec.get("model", "hosek")).lower() == "preetham"
                          else hosek_sky_image)
                img = sky_fn(sdir, turb, resolution=int(espec.get("resolution", 128)),
                             scale=sc_f * float(espec.get("sky_scale", 1.0)))
                env_tables = build_env_tables(img, 1.0)
                mean_lum = float((img @ LUM_WEIGHTS_NP).mean())
                env_id = add_emitter(EmitterKind.ENVMAP, [mean_lum] * 3,
                                     power=mean_lum * 4 * np.pi)
                env_kind = EmitterKind.ENVMAP
            if t in ("sun", "sunsky"):
                irr = preetham_sun_irradiance(sdir, turb,
                                              scale=sc_f * float(espec.get("sun_scale", 1.0)))
                add_emitter(EmitterKind.DIRECTIONAL, irr, position=-sdir, power=lum(irr))
        else:
            raise ValueError(f"unknown emitter type {t}")
    return env_id, env_kind, env_tables


def build_scene(desc: dict, device=None) -> SceneData:
    """Compile a scene description onto ``device`` (None = the card)."""
    dev = resolve_device(device)
    shapes = desc.get("shapes", [])
    if not shapes:
        raise ValueError("scene has no shapes")

    mat_rows: list[dict] = []
    mat_cache: dict[str, int] = {}
    texture_images: list = []

    def intern(row):
        key = repr(sorted((k, repr(v)) for k, v in row.items()))
        if key not in mat_cache:
            mat_cache[key] = len(mat_rows)
            mat_rows.append(row)
        return mat_cache[key]

    def register_sub(bspec):
        # nested lobes are plain families: a wrapper here raises
        return intern(_compile_bsdf(bspec, texture_images, register_sub=None))

    def mat_index(bspec):
        return intern(_compile_bsdf(bspec or {"type": "diffuse"}, texture_images, register_sub))

    tris = {k: [] for k in ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2")}
    tri_mat, tri_emitter = [], []
    em = {k: [] for k in ("kind", "tri", "radiance", "position", "aux", "cutoff", "area", "power")}

    def add_emitter(kind, radiance, position=(0, 0, 0), aux=(0, 0, 1), cutoff=(0.0, 0.0),
                    tri=-1, area=1.0, power=1.0):
        em["kind"].append(kind)
        em["tri"].append(tri)
        em["radiance"].append(np.asarray(radiance, dtype=np.float64))
        em["position"].append(np.asarray(position, dtype=np.float64))
        em["aux"].append(np.asarray(aux, dtype=np.float64))
        em["cutoff"].append(np.asarray(cutoff, dtype=np.float64))
        em["area"].append(area)
        em["power"].append(max(power, 1e-12))
        return len(em["kind"]) - 1

    # shape groups are templates, instances stamp them with a transform
    groups: dict[str, list] = {}
    flat_shapes = []
    for sh in shapes:
        if sh.get("type") == "shapegroup":
            groups[sh["id"]] = sh["shapes"]
            continue
        if sh.get("type") == "instance":
            tw = _to_world(sh)
            for member in groups[sh["ref"]]:
                member = dict(member)
                member["to_world"] = tw @ _to_world(member)
                if "bsdf" in sh and "bsdf" not in member:
                    member["bsdf"] = sh["bsdf"]
                flat_shapes.append(member)
            continue
        flat_shapes.append(sh)

    tri_vcol: list = []
    any_vcol = False
    for sh in flat_shapes:
        if sh.get("subsurface") is not None:
            _not_ported("subsurface scattering", "Queue 1 item 9 (integrators)")
        mesh = SHAPE_BUILDERS[sh["type"]](sh).transformed(_to_world(sh))
        if sh.get("flip_normals"):
            mesh = mesh.flipped()
        p0, e1, e2, n0, n1, n2, uv0, uv1, uv2 = mesh.face_arrays()
        mid = mat_index(sh.get("bsdf"))
        base = len(tri_mat)
        for k, v in zip(tris, (p0, e1, e2, n0, n1, n2, uv0, uv1, uv2)):
            tris[k].append(v)
        nf = len(p0)
        tri_mat.extend([mid] * nf)
        # geometry-driven textures: per-face vertex colours (F, 9)
        tex_spec = (sh.get("bsdf") or {}).get("texture") or {}
        ttype = tex_spec.get("type")
        if ttype == "vertexcolors":
            fc = mesh.face_colors()
            if fc is None:
                fc = np.ones((nf, 9), np.float32)
            tri_vcol.append(np.asarray(fc, np.float32))
            any_vcol = True
        elif ttype == "curvature":
            cc = curvature_colors(mesh, kind=tex_spec.get("curvature", "mean"),
                                  scale=float(tex_spec.get("scale", 1.0)))
            f = mesh.faces
            fc = np.concatenate([cc[f[:, 0]], cc[f[:, 1]], cc[f[:, 2]]], axis=-1)
            tri_vcol.append(np.asarray(fc, np.float32))
            any_vcol = True
        else:
            tri_vcol.append(np.zeros((nf, 9), np.float32))
        if "emitter" in sh and sh["emitter"] is not None:
            rad = _rgb(sh["emitter"].get("radiance"), [1.0, 1.0, 1.0])
            lum = float(np.dot(rad, LUM_WEIGHTS_NP))
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            for f in range(nf):
                eid = add_emitter(
                    EmitterKind.AREA, rad, tri=base + f, area=float(areas[f]),
                    power=lum * float(areas[f]) * np.pi,
                )
                tri_emitter.append(eid)
        else:
            tri_emitter.extend([-1] * nf)

    env_id, env_kind, env_tables = _compile_emitters(desc.get("emitters", []), add_emitter)
    if not em["kind"]:
        raise ValueError("scene has no emitters")

    catf = lambda a: np.concatenate(a, axis=0).astype(np.float32)  # noqa: E731
    h = {k: catf(v) for k, v in tris.items()}
    tri_mat_np = np.asarray(tri_mat, dtype=np.int32)
    tri_em_np = np.asarray(tri_emitter, dtype=np.int32)
    T = len(tri_mat_np)
    # the tables are cut from host arrays and moved to the device once
    bvh = build_bvh(h["p0"], h["e1"], h["e2"])
    if bvh.max_depth + 2 > STACK_SIZE:
        raise ValueError(f"BVH depth {bvh.max_depth} exceeds traversal stack {STACK_SIZE}")
    blocks = pairs = None
    if T >= TWOLEVEL_MIN_TRIS:
        blocks = to_device(build_blocklist(h["p0"], h["e1"], h["e2"], bvh), dev)
        pairs = to_device(build_pair_table(h["p0"], h["e1"], h["e2"], bvh), dev)
    bvh = pack_bvh(to_device(bvh, dev), *(torch.as_tensor(h[k], device=dev)
                                          for k in ("p0", "e1", "e2")))

    # packed shading rows (see the Geometry.shade_packed layout)
    gn = np.cross(h["e1"], h["e2"])
    tri_area = 0.5 * np.linalg.norm(gn, axis=-1)
    gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    has_em = tri_em_np >= 0
    eidx = np.maximum(tri_em_np, 0)
    tri_emission = np.where(has_em[:, None], np.stack(em["radiance"])[eidx], 0.0)
    shade = np.zeros((T, 32), dtype=np.float32)
    shade[:, 0:3] = gn
    shade[:, 3:6] = h["n0"]
    shade[:, 6:9] = h["n1"]
    shade[:, 9:12] = h["n2"]
    shade[:, 12:14] = h["uv0"]
    shade[:, 14:16] = h["uv1"]
    shade[:, 16:18] = h["uv2"]
    shade[:, 18] = tri_mat_np.astype(np.float32)
    shade[:, 19] = tri_em_np.astype(np.float32)
    shade[:, 20:23] = tri_emission
    shade[:, 25] = tri_area
    uv_e1 = h["uv1"] - h["uv0"]
    uv_e2 = h["uv2"] - h["uv0"]
    uv_area = 0.5 * np.abs(uv_e1[:, 0] * uv_e2[:, 1] - uv_e1[:, 1] * uv_e2[:, 0])
    shade[:, 26] = np.sqrt(uv_area / np.maximum(tri_area, 1e-20))
    shade[:, 27] = -1.0  # no subsurface rows

    power = np.asarray(em["power"], dtype=np.float64)
    pmf = power / power.sum()
    cdf = np.cumsum(pmf)
    # per-triangle emitter pmf for MIS on emissive hits
    shade[:, 23] = np.where(has_em, pmf[eidx].astype(np.float32), 0.0)

    M = len(mat_rows)
    mpk = np.zeros((M, 32), dtype=np.float32)
    mpk[:, 0] = [m["type"] for m in mat_rows]
    mpk[:, 1:4] = np.stack([m["reflectance"] for m in mat_rows])
    mpk[:, 4:7] = np.stack([m["specular"] for m in mat_rows])
    mpk[:, 7:10] = np.stack([m["eta"] for m in mat_rows])
    mpk[:, 10:13] = np.stack([m["k"] for m in mat_rows])
    mpk[:, 13] = [m["alpha"] for m in mat_rows]
    mpk[:, 14] = [m["texture_id"] for m in mat_rows]
    mpk[:, 15] = [m.get("alpha_v", m["alpha"]) for m in mat_rows]
    mpk[:, 16] = [m.get("sub_a", -1) for m in mat_rows]
    mpk[:, 17] = [m.get("sub_b", -1) for m in mat_rows]
    mpk[:, 18] = [m.get("weight", 0.0) for m in mat_rows]
    mpk[:, 19] = [m.get("bump_tex_id", -1) for m in mat_rows]
    mpk[:, 20] = [m.get("bump_scale", 1.0) for m in mat_rows]
    # the wireframe's edge colour and line width (texture_id -4)
    mpk[:, 21:24] = np.stack([np.asarray(m.get("wire_edge", (0.0, 0.0, 0.0)), np.float32)
                              for m in mat_rows])
    mpk[:, 24] = [m.get("wire_lw", 0.0) for m in mat_rows]
    # UV tiling factors, applied before the atlas and normal-map fetches
    mpk[:, 25:27] = [m.get("uv_scale", (1.0, 1.0)) for m in mat_rows]
    # the cloth's geometry (scene/types.py CLOTH: w, l, areaW, areaF, fb_scale)
    mpk[:, 27:32] = [m.get("cloth_extra", (0.0,) * 5) for m in mat_rows]
    # the coat interfaces' transmittance over cos(theta): quadrature for a
    # rough interface, the exact smooth Fresnel otherwise
    coat_tab = np.zeros((M, N_COS), np.float32)
    for i, m in enumerate(mat_rows):
        if m["type"] == BSDFType.COATING:
            coat_tab[i] = coat_transmittance_table(float(m["alpha"]), float(m["eta"][0]))

    E = len(em["kind"])
    epk = np.zeros((E, 32), dtype=np.float32)
    epk[:, 0] = np.asarray(em["kind"], dtype=np.float32)
    epk[:, 1] = pmf.astype(np.float32)
    epk[:, 2:5] = np.stack(em["radiance"]).astype(np.float32)
    epk[:, 5:8] = np.stack(em["position"]).astype(np.float32)
    epk[:, 8:11] = np.stack(em["aux"]).astype(np.float32)
    epk[:, 11:13] = np.stack(em["cutoff"]).astype(np.float32)
    epk[:, 13] = np.asarray(em["area"], dtype=np.float32)
    etri = np.asarray(em["tri"], dtype=np.int64)
    has_tri = etri >= 0
    ei = np.maximum(etri, 0)
    epk[:, 14:17] = np.where(has_tri[:, None], h["p0"][ei], 0.0)
    epk[:, 17:20] = np.where(has_tri[:, None], h["e1"][ei], 0.0)
    epk[:, 20:23] = np.where(has_tri[:, None], h["e2"][ei], 0.0)
    epk[:, 23:26] = np.where(has_tri[:, None], gn[ei], 0.0)

    # np.array copies C-contiguous and keeps 0-d scalars 0-d
    t = lambda a, dtype=torch.float32: torch.as_tensor(  # noqa: E731
        np.array(a), dtype=dtype, device=dev)
    geo = Geometry(
        p0=t(h["p0"]), e1=t(h["e1"]), e2=t(h["e2"]),
        n0=t(h["n0"]), n1=t(h["n1"]), n2=t(h["n2"]),
        uv0=t(h["uv0"]), uv1=t(h["uv1"]), uv2=t(h["uv2"]),
        mat_id=t(tri_mat_np, torch.int32), emitter_id=t(tri_em_np, torch.int32),
        shade_packed=t(shade),
        vcol=t(np.concatenate(tri_vcol, axis=0)) if any_vcol else None,
    )
    mats = Materials(
        type=t(np.asarray([m["type"] for m in mat_rows], np.int32), torch.int32),
        reflectance=t(np.stack([m["reflectance"] for m in mat_rows]).astype(np.float32)),
        specular=t(np.stack([m["specular"] for m in mat_rows]).astype(np.float32)),
        eta=t(np.stack([m["eta"] for m in mat_rows]).astype(np.float32)),
        k=t(np.stack([m["k"] for m in mat_rows]).astype(np.float32)),
        alpha=t(np.asarray([m["alpha"] for m in mat_rows], np.float32)),
        texture_id=t(np.asarray([m["texture_id"] for m in mat_rows], np.int32), torch.int32),
        packed=t(mpk),
        coat_trans=t(coat_tab),
    )
    if env_id >= 0:
        env_radiance = np.asarray(em["radiance"][env_id], dtype=np.float32)
        if env_kind == EmitterKind.ENVMAP:
            # the pick pmf; the directional factor is env_pdf_tex's
            env_pdf = np.float32(pmf[env_id])
        else:
            env_pdf = np.float32(pmf[env_id] / (4.0 * np.pi))
            env_tables = constant_env_tables(env_radiance)
    else:
        env_radiance = np.zeros(3, dtype=np.float32)
        env_pdf = np.float32(0.0)
        env_tables = constant_env_tables(env_radiance)
    emitters = Emitters(
        kind=t(np.asarray(em["kind"], np.int32), torch.int32),
        tri=t(np.asarray(em["tri"], np.int32), torch.int32),
        radiance=t(np.stack(em["radiance"]).astype(np.float32)),
        position=t(np.stack(em["position"]).astype(np.float32)),
        aux=t(np.stack(em["aux"]).astype(np.float32)),
        cutoff=t(np.stack(em["cutoff"]).astype(np.float32)),
        area=t(np.asarray(em["area"], np.float32)),
        pmf=t(pmf.astype(np.float32)),
        cdf=t(cdf.astype(np.float32)),
        env_radiance=t(env_radiance),
        env_pdf=t(env_pdf),
        packed=t(epk),
        **{k: t(v) for k, v in env_tables.items()},
    )

    sspec = desc.get("sensor", {})
    skind = _SENSOR_KINDS.get(sspec.get("type", "perspective"), SensorKind.PERSPECTIVE)
    # fov is along x; the y extent follows the aspect ratio at ray
    # generation.  Orthographic and telecentric sensors take a half-width.
    tan_half = np.tan(np.deg2rad(float(sspec.get("fov", 45.0))) / 2)
    if skind in (SensorKind.ORTHOGRAPHIC, SensorKind.TELECENTRIC):
        tan_half = float(sspec.get("ortho_width", 1.0))
    kc = sspec.get("kc", None)  # perspective_rdist's distortion polynomial
    # the measurement probes' constant weight, folded in at develop time
    meas = {SensorKind.IRRADIANCEMETER: np.pi, SensorKind.FLUENCEMETER: 4 * np.pi}
    sensor = Sensor(
        to_world=t(np.asarray(sspec.get("to_world", look_at([0, 0, -5], [0, 0, 0]))).astype(np.float32)),
        tan_half_fov_x=t(np.float32(tan_half)),
        tan_half_fov_y=t(np.float32(tan_half)),
        aperture_radius=t(np.float32(sspec.get("aperture_radius", 0.0))),
        focus_distance=t(np.float32(sspec.get("focus_distance", 1.0))),
        near_clip=t(np.float32(sspec.get("near_clip", 1e-3))),
        kind=skind,
        kc=None if kc is None else t(np.asarray(kc, dtype=np.float32)),
        meas_scale=t(np.float32(meas[skind])) if skind in meas else None,
    )
    medium = _compile_medium(desc.get("medium"), t)

    p0h, e1h, e2h = h["p0"], h["e1"], h["e2"]
    v1 = p0h + e1h
    v2 = p0h + e2h
    lo = np.minimum(np.minimum(p0h, v1), v2).min(axis=0)
    hi = np.maximum(np.maximum(p0h, v1), v2).max(axis=0)
    pad = 1e-3 * (hi - lo).max() + 1e-6
    atlas, sizes = build_atlas_np(texture_images)
    return SceneData(
        geo=geo, bvh=bvh, mats=mats, emitters=emitters, sensor=sensor,
        medium=medium,
        aabb_min=t((lo - pad).astype(np.float32)),
        aabb_max=t((hi + pad).astype(np.float32)),
        textures=t(atlas),
        texture_sizes=t(sizes),
        sss_packed=None, blocks=blocks, pairs=pairs,
    )
