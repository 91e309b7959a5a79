"""Mitsuba-XML scene loader: a compatible subset of the reference format.

A copy of the JAX package's numpy-only scene/xml_loader.py, the
counterpart of Mitsuba's librender/scenehandler.cpp (Xerces SAX -> tag
stack -> Properties -> PluginManager): parses Mitsuba 0.x scene XML
(stdlib ElementTree — no schema validation pass) into the dict scene
description consumed by scene/builder.py.  Supports the tags the builder
understands: shapes (obj/ply/rectangle/cube/sphere/disk/serialized*),
bsdf types with ref/id reuse, area/constant/point/spot/directional
emitters, perspective/thinlens sensors with film size, homogeneous media,
``<transform>`` stacks (translate/rotate/scale/matrix/lookat), `$key`
defaults substitution (reference CLI -D, scenehandler attribute
resolution), and integrator/sampler settings mapped onto RenderConfig.

Unknown plugin types are an ERROR by default (the reference validates
scenes against data/schema/scene.xsd and warns on unused keys,
scenehandler.cpp:824, properties.h:214-217 — a scene must not silently
render wrong); pass ``strict=False`` to degrade unknown BSDFs to diffuse
and skip unknown shapes/emitters with a warning instead.
"""
from __future__ import annotations

import os
import re
import warnings
import xml.etree.ElementTree as ET

import numpy as np

from mitsuba_path_guiding_torch.scene.transforms import (
    look_at,
    rotate,
    scale as scale_m,
    translate,
)

_SUPPORTED_BSDFS = {
    "diffuse", "roughdiffuse", "conductor", "roughconductor", "dielectric",
    "thindielectric", "roughdielectric", "plastic", "roughplastic", "phong",
    "null", "twosided", "mask", "bumpmap", "normalmap", "coating", "ward",
    "mixturebsdf", "blendbsdf", "difftrans", "hk", "irawan",
}
# unwrapped adapters: two-sided is the default shading model here
_WRAPPER_BSDFS = {"twosided"}
# frame-perturbing wrappers compiled to the child row + bump fields
# (reference src/bsdfs/bumpmap.cpp, normalmap.cpp)
_BUMP_BSDFS = {"bumpmap", "normalmap"}
# wrappers that KEEP their semantics as builder dicts with a nested bsdf
_NESTED_BSDFS = {"mask", "coating", "roughcoating"}
_SHAPES = {"obj", "ply", "rectangle", "cube", "sphere", "disk", "serialized", "cylinder", "heightfield", "hair"}


def _resolve_file(fn: str, base_dir: str) -> str:
    """Reference FileResolver behavior (fresolver.h): relative paths are
    searched in the scene directory, then its ancestors (fixtures refer to
    'data/tests/x' relative to the project root), then the cwd."""
    if os.path.isabs(fn):
        return fn
    d = base_dir
    for _ in range(8):
        cand = os.path.join(d, fn)
        if os.path.exists(cand):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return os.path.join(base_dir, fn)


def _subst(text: str, defaults: dict) -> str:
    """$var substitution (reference -D defines)."""
    if text is None:
        return text
    return re.sub(r"\$(\w+)", lambda m: str(defaults.get(m.group(1), m.group(0))), text)


def _parse_value(el, defaults):
    t = el.tag
    v = _subst(el.get("value"), defaults)
    if t == "float":
        return float(v)
    if t == "integer":
        return int(v)
    if t == "boolean":
        return v.lower() == "true"
    if t == "string":
        return v
    if t in ("spectrum", "rgb", "srgb"):
        if v is None:
            return [1.0, 1.0, 1.0]
        parts = [float(x) for x in re.split(r"[ ,]+", v.strip()) if x]
        if len(parts) == 1:
            return [parts[0]] * 3
        return parts[:3]
    if t in ("point", "vector"):
        return [
            float(_subst(el.get(a), defaults) or 0.0) for a in ("x", "y", "z")
        ]
    return v


def _parse_transform(el, defaults):
    m = np.eye(4)
    for child in el:
        tag = child.tag
        g = lambda a, d=0.0: float(_subst(child.get(a), defaults) or d)
        if tag == "translate":
            m = translate(g("x"), g("y"), g("z")) @ m
        elif tag == "scale":
            if child.get("value") is not None:
                sv = float(_subst(child.get("value"), defaults))
                m = scale_m(sv) @ m
            else:
                m = scale_m(g("x", 1.0), g("y", 1.0), g("z", 1.0)) @ m
        elif tag == "rotate":
            axis = [g("x"), g("y"), g("z")]
            m = rotate(axis, g("angle")) @ m
        elif tag == "matrix":
            vals = [float(x) for x in _subst(child.get("value"), defaults).split()]
            m = np.asarray(vals, dtype=np.float64).reshape(4, 4) @ m
        elif tag in ("lookat", "lookAt"):
            origin = [float(x) for x in re.split(r"[ ,]+", _subst(child.get("origin"), defaults).strip())]
            target = [float(x) for x in re.split(r"[ ,]+", _subst(child.get("target"), defaults).strip())]
            up_attr = child.get("up")
            up = (
                [float(x) for x in re.split(r"[ ,]+", _subst(up_attr, defaults).strip())]
                if up_attr
                else [0.0, 1.0, 0.0]
            )
            m = look_at(origin, target, up) @ m
    return m


def _props(el, defaults):
    """Collect named child properties into a dict."""
    out = {}
    for child in el:
        name = child.get("name")
        if child.tag in ("float", "integer", "boolean", "string", "spectrum", "rgb", "srgb", "point", "vector"):
            if name:
                out[name] = _parse_value(child, defaults)
        elif child.tag == "transform":
            out[child.get("name", "to_world").replace("toWorld", "to_world")] = _parse_transform(child, defaults)
    if "toWorld" in out:
        out["to_world"] = out.pop("toWorld")
    return out


def _parse_bsdf(el, defaults, bsdf_registry, strict=True):
    t = el.get("type", "diffuse")
    # blend/mixture keep BOTH children (builder BLEND row)
    if t in ("mixturebsdf", "blendbsdf"):
        subs = [
            _parse_bsdf(c, defaults, bsdf_registry, strict) for c in el.findall("bsdf")
        ]
        for r in el.findall("ref"):
            if r.get("id") in bsdf_registry:
                subs.append(bsdf_registry[r.get("id")])
        p = _props(el, defaults)
        if t == "mixturebsdf":
            ws = p.get("weights", "0.5 0.5")
            weights = [float(x) for x in re.split(r"[ ,]+", str(ws).strip()) if x]
        else:
            weights = [1.0 - float(p.get("weight", 0.5)), float(p.get("weight", 0.5))]
        while len(subs) < 2:
            subs.append({"type": "diffuse"})
        b = {"type": t, "bsdfs": subs[:2], "weights": weights[:2]}
        if el.get("id"):
            bsdf_registry[el.get("id")] = b
        return b
    if t in _BUMP_BSDFS:
        inner = el.find("bsdf")
        if inner is not None:
            b = _parse_bsdf(inner, defaults, bsdf_registry, strict)
        else:
            ref = el.find("ref")
            b = bsdf_registry.get(ref.get("id"), {"type": "diffuse"}) if ref is not None else {"type": "diffuse"}
        p = _props(el, defaults)
        w = {"type": t, "bsdf": b}
        if "scale" in p:
            w["scale"] = float(p["scale"])
        tex_el = el.find("texture")
        if tex_el is not None:
            tp = _props(tex_el, defaults)
            tex = {"type": tex_el.get("type", "bitmap")}
            for key in ("filename", "uscale", "vscale", "color0", "color1"):
                if key in tp:
                    tex[key] = tp[key]
            w["texture"] = tex
        if el.get("id"):
            bsdf_registry[el.get("id")] = w
        return w
    if t in _WRAPPER_BSDFS or t in _NESTED_BSDFS:
        inner = el.find("bsdf")
        if inner is not None:
            b = _parse_bsdf(inner, defaults, bsdf_registry, strict)
        else:
            ref = el.find("ref")
            b = bsdf_registry.get(ref.get("id"), {"type": "diffuse"}) if ref is not None else {"type": "diffuse"}
        if t in _NESTED_BSDFS:
            # keep the wrapper semantics as a builder dict with nested bsdf
            p = _props(el, defaults)
            w = {"type": "coating" if t == "roughcoating" else t, "bsdf": b}
            for src, dst in (
                ("opacity", "opacity"), ("thickness", "thickness"),
                ("sigmaA", "sigma_a"), ("sigma_a", "sigma_a"),
                ("intIOR", "int_ior"), ("extIOR", "ext_ior"),
                ("int_ior", "int_ior"), ("ext_ior", "ext_ior"),
            ):
                if src in p:
                    w[dst] = p[src]
            b = w
        if el.get("id"):
            bsdf_registry[el.get("id")] = b
        return b
    if t not in _SUPPORTED_BSDFS:
        if strict:
            raise ValueError(
                f"unsupported BSDF type in XML: '{t}' (supported: "
                f"{sorted(_SUPPORTED_BSDFS)}); pass strict=False to "
                f"degrade unknown BSDFs to diffuse"
            )
        warnings.warn(f"XML: unknown BSDF '{t}' degraded to diffuse")
        b = {"type": "diffuse"}
    else:
        b = {"type": t}
    p = _props(el, defaults)
    # name mapping XML -> builder keys
    ren = {
        "reflectance": "reflectance",
        "diffuseReflectance": "reflectance",
        "diffuse_reflectance": "reflectance",
        "specularReflectance": "specular_reflectance",
        "specular_reflectance": "specular_reflectance",
        "intIOR": "int_ior",
        "int_ior": "int_ior",
        "extIOR": "ext_ior",
        "ext_ior": "ext_ior",
        "alpha": "alpha",
        "material": "material",
        "eta": "eta",
        "k": "k",
        "exponent": "exponent",
    }
    for k, v in p.items():
        if k in ren:
            b[ren[k]] = v
    if t == "irawan":
        # the weave pattern filename, repeat factors, and any custom
        # parameters must reach the builder verbatim — pattern files
        # reference them as $identifier (irawan.cpp "additional
        # parameters"; resolved in models/cloth.py parse_weave)
        for k, v in p.items():
            b.setdefault(k, v)
    # nested <texture name="reflectance" type="bitmap|checkerboard|...">
    tex_el = el.find("texture")
    if tex_el is not None:
        tp = _props(tex_el, defaults)
        tex = {"type": tex_el.get("type", "bitmap")}
        for key in ("filename", "uscale", "vscale", "color0", "color1"):
            if key in tp:
                tex[key] = tp[key]
        b["texture"] = tex
    if "exponent" in b:  # phong exponent -> alpha
        expn = float(b.pop("exponent"))
        b["alpha"] = float(np.sqrt(2.0 / (expn + 2.0)))
    if el.get("id"):
        bsdf_registry[el.get("id")] = b
    return b


_CURRENT_VERSION = (0, 6, 0)


def _upgrade_tree(root) -> None:
    """Scene-version auto-migration (reference
    data/schema/upgrade_0.{3,4,5}.0.xsl applied by scenehandler.cpp:824):
    scenes declaring an older ``version`` are rewritten in place to the
    current dialect — tag renames (camera->sensor, luminaire->emitter),
    plugin renames (lambertian->diffuse, mirror->conductor,
    roughmetal->roughconductor, roughglass->roughdielectric,
    composite->mixturebsdf, bump->bumpmap, exrfilm->hdrfilm,
    pngfilm->ldrfilm, errctrl->adaptive, exr/ldrtexture->bitmap) and
    property renames, mirroring the XSLT templates."""
    ver = root.get("version", "0.3.0")
    try:
        vt = tuple(int(x) for x in ver.split("."))
    except ValueError:
        vt = (0, 3, 0)
    if vt >= _CURRENT_VERSION:
        return

    def walk(parent):
        for el in list(parent):
            walk(el)
            tag, t = el.tag, el.get("type")
            if tag == "camera":                     # 0.4: camera -> sensor
                el.tag = "sensor"
            elif tag == "luminaire":                # 0.4: luminaire -> emitter
                el.tag = "emitter"
                for c in el:
                    if c.get("name") == "intensity" and t in (
                            "area", "constant"):
                        c.set("name", "radiance")
                    elif c.get("name") == "intensity" and t == "directional":
                        c.set("name", "irradiance")
            if tag == "bsdf":
                renames = {
                    "lambertian": "diffuse", "mirror": "conductor",
                    "roughmetal": "roughconductor",
                    "roughglass": "roughdielectric",
                    "composite": "mixturebsdf", "microfacet": "roughplastic",
                    "bump": "bumpmap",
                }
                if t in renames:
                    el.set("type", renames[t])
                for c in el:
                    cn = c.get("name")
                    if cn == "alphaB":
                        c.set("name", "alpha")
                    elif cn == "alphaX":
                        c.set("name", "alphaU")
                    elif cn == "alphaY":
                        c.set("name", "alphaV")
                    elif cn == "ior" and t == "roughmetal":
                        c.set("name", "eta")
            if tag == "texture":
                if t in ("exrtexture", "ldrtexture"):
                    el.set("type", "bitmap")
                for c in el:
                    if c.get("name") == "brightColor":
                        c.set("name", "color1")
                    elif c.get("name") == "darkColor":
                        c.set("name", "color0")
            if tag == "film":
                if t == "exrfilm":
                    el.set("type", "hdrfilm")
                elif t == "pngfilm":
                    el.set("type", "ldrfilm")
            if tag == "integrator" and t == "errctrl":
                el.set("type", "adaptive")
            for c in el:
                cn = c.get("name")
                if cn == "focusDepth":
                    c.set("name", "focusDistance")
                elif cn in ("intensityScale", "densityMultiplier"):
                    c.set("name", "scale")
                elif cn == "luminaireSamples":
                    c.set("name", "emitterSamples")

    walk(root)
    root.set("version", ".".join(str(x) for x in _CURRENT_VERSION))


def load_scene_xml(path_or_string: str, defaults: dict | None = None,
                   strict: bool = True):
    """Parse scene XML -> (scene_desc dict, render_settings dict).

    ``defaults``: $key substitutions (reference mitsuba -Dkey=value).
    ``strict``: unknown plugin types raise (reference schema validation);
    False degrades/skips with a warning.
    render_settings carries integrator/film/sampler info: width, height,
    spp, max_depth, rr_depth, integrator type.
    """
    defaults = dict(defaults or {})
    if os.path.exists(path_or_string):
        tree = ET.parse(path_or_string)
        root = tree.getroot()
        base_dir = os.path.dirname(os.path.abspath(path_or_string))
    else:
        root = ET.fromstring(path_or_string)
        base_dir = os.getcwd()
    _upgrade_tree(root)

    # <default name="x" value="y"/> entries fill unset $vars
    for d in root.findall("default"):
        defaults.setdefault(d.get("name"), d.get("value"))

    desc = {"shapes": [], "emitters": []}
    settings = {
        "width": 256, "height": 256, "spp": 16, "max_depth": 5,
        "rr_depth": 5, "integrator": "path",
    }
    bsdf_registry: dict = {}

    for b in root.findall("bsdf"):
        _parse_bsdf(b, defaults, bsdf_registry, strict)

    integ = root.find("integrator")
    if integ is not None:
        itype = integ.get("type", "path")
        settings["integrator"] = itype
        p = _props(integ, defaults)
        if "maxDepth" in p or "max_depth" in p:
            md = int(p.get("maxDepth", p.get("max_depth")))
            settings["max_depth"] = md if md > 0 else 16
        if "rrDepth" in p or "rr_depth" in p:
            settings["rr_depth"] = int(p.get("rrDepth", p.get("rr_depth")))

    # sensors may nest inside shapes (reference test_bidir_0.xml puts an
    # irradiancemeter on a disk shape, inheriting its transform) — search
    # the whole tree and inherit the parent shape's to_world
    sensor = root.find("sensor")
    parent_shape = None
    if sensor is None:
        for sh in root.iter("shape"):
            s = sh.find("sensor")
            if s is not None:
                sensor, parent_shape = s, sh
                break
    if sensor is not None:
        sp = _props(sensor, defaults)
        if "to_world" not in sp and parent_shape is not None:
            pp = _props(parent_shape, defaults)
            if "to_world" in pp:
                sp["to_world"] = pp["to_world"]
        stype = sensor.get("type", "perspective")
        sdesc = {"type": stype, "fov": float(sp.get("fov", 45.0))}
        if "to_world" in sp:
            sdesc["to_world"] = sp["to_world"]
        if stype == "thinlens":
            sdesc["aperture_radius"] = float(sp.get("apertureRadius", sp.get("aperture_radius", 0.0)))
            sdesc["focus_distance"] = float(sp.get("focusDistance", sp.get("focus_distance", 1.0)))
        desc["sensor"] = sdesc
        film = sensor.find("film")
        if film is not None:
            fp = _props(film, defaults)
            settings["width"] = int(fp.get("width", 256))
            settings["height"] = int(fp.get("height", 256))
        sampler = sensor.find("sampler")
        if sampler is not None:
            pp = _props(sampler, defaults)
            settings["spp"] = int(pp.get("sampleCount", pp.get("sample_count", 16)))
            settings["sampler"] = sampler.get("type", "independent")

    for sh in root.findall("shape"):
        stype = sh.get("type")
        if stype not in _SHAPES:
            if strict:
                raise ValueError(
                    f"unsupported shape type in XML: '{stype}' (supported: "
                    f"{sorted(_SHAPES)}); pass strict=False to skip it"
                )
            warnings.warn(f"XML: unknown shape '{stype}' skipped")
            continue
        p = _props(sh, defaults)
        sdesc = {"type": stype}
        if "to_world" in p:
            sdesc["to_world"] = p["to_world"]
        if p.get("flipNormals") or p.get("flip_normals"):
            sdesc["flip_normals"] = True
        if "filename" in p:
            fn = p["filename"]
            sdesc["filename"] = _resolve_file(fn, base_dir)
        if stype == "sphere":
            if "center" in p:
                sdesc["center"] = p["center"]
            if "radius" in p:
                sdesc["radius"] = float(p["radius"])
        b_el = sh.find("bsdf")
        if b_el is not None:
            sdesc["bsdf"] = _parse_bsdf(b_el, defaults, bsdf_registry, strict)
        else:
            r = sh.find("ref")
            if r is not None and r.get("id") in bsdf_registry:
                sdesc["bsdf"] = bsdf_registry[r.get("id")]
        e_el = sh.find("emitter")
        if e_el is not None and e_el.get("type") == "area":
            ep = _props(e_el, defaults)
            sdesc["emitter"] = {"radiance": ep.get("radiance", [1.0, 1.0, 1.0])}
        desc["shapes"].append(sdesc)

    for e_el in root.findall("emitter"):
        etype = e_el.get("type")
        ep = _props(e_el, defaults)
        if etype == "constant":
            desc["emitters"].append({"type": "constant", "radiance": ep.get("radiance", [1, 1, 1])})
        elif etype == "point":
            ed = {"type": "point", "intensity": ep.get("intensity", [1, 1, 1])}
            if "position" in ep:
                ed["position"] = ep["position"]
            elif "to_world" in ep:
                ed["to_world"] = ep["to_world"]
            desc["emitters"].append(ed)
        elif etype == "directional":
            desc["emitters"].append(
                {"type": "directional", "irradiance": ep.get("irradiance", [1, 1, 1]),
                 "direction": ep.get("direction", [0, 0, 1])}
            )
        elif etype == "spot":
            ed = {"type": "spot", "intensity": ep.get("intensity", [1, 1, 1])}
            if "to_world" in ep:
                ed["to_world"] = ep["to_world"]
            if "cutoffAngle" in ep or "cutoff_angle" in ep:
                ed["cutoff_angle"] = float(ep.get("cutoffAngle", ep.get("cutoff_angle")))
            desc["emitters"].append(ed)
        elif etype == "envmap":
            ed = {"type": "envmap", "scale": float(ep.get("scale", 1.0))}
            fn = ep.get("filename")
            if fn:
                ed["filename"] = _resolve_file(fn, base_dir)
            desc["emitters"].append(ed)
        elif etype in ("sky", "sun", "sunsky"):
            # procedural sky/sun (builder: Hosek-Wilkie/Preetham tables,
            # models/sunsky.py; reference src/emitters/sunsky/sky.cpp)
            ed = {"type": etype}
            for key in ("turbidity", "scale", "sunScale", "skyScale",
                        "resolution", "albedo"):
                if key in ep:
                    ed[key.replace("sunScale", "sun_scale").replace(
                        "skyScale", "sky_scale")] = ep[key]
            if "sunDirection" in ep:
                ed["sun_direction"] = ep["sunDirection"]
            desc["emitters"].append(ed)
        elif etype == "collimated":
            ed = {"type": "collimated", "power": ep.get("power", [1.0, 1.0, 1.0])}
            if "to_world" in ep:
                ed["to_world"] = ep["to_world"]
            desc["emitters"].append(ed)
        else:
            if strict:
                raise ValueError(
                    f"unsupported emitter type in XML: '{etype}'; pass "
                    f"strict=False to skip it"
                )
            warnings.warn(f"XML: unknown emitter '{etype}' skipped")

    medium = _find_medium(root)
    if medium is not None and medium.get("type") == "homogeneous":
        mp = _props(medium, defaults)
        phase = medium.find("phase")
        g = 0.0
        phase_kw = {}
        if phase is not None and phase.get("type") == "hg":
            g = float(_props(phase, defaults).get("g", 0.0))
        elif phase is not None and phase.get("type") in ("rayleigh", "isotropic"):
            phase_kw["phase"] = phase.get("type")
        elif phase is not None and phase.get("type") == "mixturephase":
            # mixturephase.cpp: "weights" string prop + nested <phase> children
            pp = _props(phase, defaults)
            ws = [
                float(w)
                for w in str(pp.get("weights", "")).replace(",", " ").replace(";", " ").split()
            ]
            comps = []
            for child in phase.findall("phase"):
                cp = _props(child, defaults)
                comps.append({"type": child.get("type", "hg"), "g": float(cp.get("g", 0.0))})
            phase_kw["phase"] = "mixture"
            phase_kw["phase_weights"] = ws
            phase_kw["phase_components"] = comps
        desc["medium"] = {
            "sigma_a": mp.get("sigmaA", mp.get("sigma_a", [0.0] * 3)),
            "sigma_s": mp.get("sigmaS", mp.get("sigma_s", [0.0] * 3)),
            "g": g,
            **phase_kw,
        }

    return desc, settings


def _find_medium(root):
    return root.find("medium")


def load_bsdfs_xml(path_or_string: str, defaults: dict | None = None,
                   strict: bool = True) -> list:
    """Parse a BSDF-fixture scene (reference data/tests/test_bsdf.xml is a
    bare list of <bsdf> instances consumed by the chi-square testcase,
    test_chisquare.cpp:397) into a list of builder bsdf dicts."""
    defaults = dict(defaults or {})
    if os.path.exists(path_or_string):
        root = ET.parse(path_or_string).getroot()
    else:
        root = ET.fromstring(path_or_string)
    registry: dict = {}
    out = []
    for b in root.findall("bsdf"):
        try:
            out.append(_parse_bsdf(b, defaults, registry, strict))
        except ValueError:
            if strict:
                raise
    return out
