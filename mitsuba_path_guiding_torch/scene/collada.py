"""COLLADA (.dae) scene importer.

A copy of the JAX package's numpy-only scene/collada.py, the
counterpart of Mitsuba's ``mtsimport`` converter (converter/collada.cpp
and mtsimport.cpp): COLLADA
geometry + scene graph + basic materials import into the builder's dict
scene schema.  Subset: library_geometries meshes (triangles/polylist with
POSITION/NORMAL/TEXCOORD inputs), library_visual_scenes node hierarchies
(matrix/translate/rotate/scale elements, instance_geometry with material
binding), library_materials/effects diffuse colors, and perspective
cameras.  Lights/animations/skinning are out of scope (the reference
importer also flattens to static geometry).
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


def _tag(el):
    return el.tag.split("}")[-1]


def _find(el, name):
    for c in el.iter():
        if _tag(c) == name:
            return c
    return None


def _children(el, name):
    return [c for c in el if _tag(c) == name]


def _floats(text):
    return np.asarray([float(x) for x in text.split()], np.float64)


def _parse_sources(mesh_el):
    """id -> (N, stride) float arrays from <source>."""
    out = {}
    for src in _children(mesh_el, "source"):
        arr_el = _find(src, "float_array")
        if arr_el is None:
            continue
        data = _floats(arr_el.text)
        acc = _find(src, "accessor")
        stride = int(acc.get("stride", 1)) if acc is not None else 1
        out["#" + src.get("id")] = data.reshape(-1, stride)
    # vertices indirection: <vertices id=X><input source="#pos"/></vertices>
    verts = _find(mesh_el, "vertices")
    if verts is not None:
        inp = _find(verts, "input")
        if inp is not None and inp.get("source") in out:
            out["#" + verts.get("id")] = out[inp.get("source")]
    return out


def _parse_prims(mesh_el, sources):
    """Yield (material_symbol, vertices (V,3), faces (F,3), normals, uvs)
    from <triangles>/<polylist> blocks, rewired to per-corner indexing."""
    for prim in list(mesh_el):
        kind = _tag(prim)
        if kind not in ("triangles", "polylist", "polygons"):
            continue
        inputs = []  # (offset, semantic, array)
        max_off = 0
        for inp in _children(prim, "input"):
            off = int(inp.get("offset", 0))
            max_off = max(max_off, off)
            inputs.append((off, inp.get("semantic"), sources.get(inp.get("source"))))
        stride = max_off + 1
        p_el = _children(prim, "p")
        if not p_el:
            continue
        idx = np.concatenate([_floats(p.text).astype(np.int64) for p in p_el])
        idx = idx.reshape(-1, stride)
        if kind == "polylist":
            vcount = _floats(_find(prim, "vcount").text).astype(np.int64)
            # fan-triangulate each polygon
            tri_rows = []
            pos = 0
            for n in vcount:
                for k in range(1, int(n) - 1):
                    tri_rows += [pos, pos + k, pos + k + 1]
                pos += int(n)
            idx = idx[tri_rows]
        corners = idx.shape[0]
        v = n_arr = uv = None
        for off, sem, arr in inputs:
            if arr is None:
                continue
            take = arr[idx[:, off]]
            if sem in ("VERTEX", "POSITION"):
                v = take[:, :3]
            elif sem == "NORMAL":
                n_arr = take[:, :3]
            elif sem == "TEXCOORD" and uv is None:
                uv = take[:, :2]
        if v is None:
            continue
        faces = np.arange(corners, dtype=np.int64).reshape(-1, 3)
        yield prim.get("material"), v, faces, n_arr, uv


def _node_transform(node):
    m = np.eye(4)
    for el in node:
        t = _tag(el)
        if t == "matrix":
            m = m @ _floats(el.text).reshape(4, 4)
        elif t == "translate":
            x = _floats(el.text)
            tm = np.eye(4)
            tm[:3, 3] = x[:3]
            m = m @ tm
        elif t == "rotate":
            x = _floats(el.text)
            axis = x[:3] / max(np.linalg.norm(x[:3]), 1e-12)
            a = np.deg2rad(x[3])
            c, s = np.cos(a), np.sin(a)
            ux, uy, uz = axis
            r = np.eye(4)
            r[:3, :3] = np.array([
                [c + ux * ux * (1 - c), ux * uy * (1 - c) - uz * s, ux * uz * (1 - c) + uy * s],
                [uy * ux * (1 - c) + uz * s, c + uy * uy * (1 - c), uy * uz * (1 - c) - ux * s],
                [uz * ux * (1 - c) - uy * s, uz * uy * (1 - c) + ux * s, c + uz * uz * (1 - c)],
            ])
            m = m @ r
        elif t == "scale":
            x = _floats(el.text)
            m = m @ np.diag([x[0], x[1], x[2], 1.0])
    return m


def _parse_materials(root):
    """material id -> bsdf dict (diffuse color from the bound effect)."""
    effects = {}
    for eff in root.iter():
        if _tag(eff) != "effect":
            continue
        color = None
        for d in eff.iter():
            if _tag(d) == "diffuse":
                c = _find(d, "color")
                if c is not None:
                    color = _floats(c.text)[:3]
        effects["#" + eff.get("id")] = color
    mats = {}
    for mat in root.iter():
        if _tag(mat) != "material":
            continue
        inst = _find(mat, "instance_effect")
        color = effects.get(inst.get("url")) if inst is not None else None
        bsdf = {"type": "diffuse"}
        if color is not None:
            bsdf["reflectance"] = [float(x) for x in color]
        mats[mat.get("id")] = bsdf
    return mats


def load_dae(path: str) -> dict:
    """Parse a .dae file into the builder's scene-description dict
    (shapes as trimesh specs; perspective camera if present)."""
    root = ET.parse(path).getroot()
    # Z_UP -> Y_UP fix like the reference importer
    up = _find(root, "up_axis")
    fix = np.eye(4)
    if up is not None and up.text and up.text.strip() == "Z_UP":
        fix = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1.0]])

    geoms = {}  # geometry id -> list of prim tuples
    for g in root.iter():
        if _tag(g) != "geometry":
            continue
        mesh = _find(g, "mesh")
        if mesh is None:
            continue
        sources = _parse_sources(mesh)
        geoms["#" + g.get("id")] = list(_parse_prims(mesh, sources))

    mats = _parse_materials(root)
    shapes = []
    sensor = {"type": "perspective", "fov": 45.0}

    def walk(node, parent_m):
        m = parent_m @ _node_transform(node)
        for el in node:
            t = _tag(el)
            if t == "instance_geometry":
                # material binding: symbol -> material id
                binding = {}
                for bm in el.iter():
                    if _tag(bm) == "instance_material":
                        binding[bm.get("symbol")] = bm.get("target", "#")[1:]
                for sym, v, faces, n_arr, uv in geoms.get(el.get("url"), []):
                    bsdf = mats.get(binding.get(sym, ""), {"type": "diffuse"})
                    shapes.append({
                        "type": "trimesh", "vertices": v, "faces": faces,
                        "normals": n_arr, "uvs": uv, "to_world": m,
                        "bsdf": dict(bsdf),
                    })
            elif t == "instance_camera":
                sensor["to_world"] = m
            elif t == "node":
                walk(el, m)

    for vs in root.iter():
        if _tag(vs) == "visual_scene":
            for node in _children(vs, "node"):
                walk(node, fix)

    out = {"sensor": sensor, "shapes": shapes, "emitters": []}
    return out
