"""The plain reference's compile of a frozen scene description: every
shape tessellated in its canonical space (a unit square at z = 0 with
normal +z, the [-1, 1] cube with outward faces, a UV sphere of
``sphere_res`` rings by twice as many segments), moved to world space by
its ``to_world`` (normals by the inverse transpose, winding reversed under
a mirroring transform) and flattened into one triangle list in shape
order.  numpy, float64; it imports nothing of the program."""
import numpy as np


def _rectangle():
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], dtype=np.float64)
    return v, np.array([[0, 1, 2], [0, 2, 3]]), np.tile([0.0, 0.0, 1.0], (4, 1))


def _cube():
    verts, faces, normals = [], [], []
    for n, u, w in [((0, 0, 1), (1, 0, 0), (0, 1, 0)), ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
                    ((1, 0, 0), (0, 1, 0), (0, 0, 1)), ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
                    ((0, 1, 0), (0, 0, 1), (1, 0, 0)), ((0, -1, 0), (1, 0, 0), (0, 0, 1))]:
        n, u, w = (np.array(x, dtype=np.float64) for x in (n, u, w))
        base = len(verts)
        for su, sw in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            verts.append(n + su * u + sw * w)
            normals.append(n)
        faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return np.array(verts), np.array(faces), np.array(normals)


def _sphere(rings):
    segs = 2 * rings
    theta = np.linspace(0, np.pi, rings + 1)
    phi = np.linspace(0, 2 * np.pi, segs + 1)[:-1]
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    v = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], -1).reshape(-1, 3)
    idx = np.arange((rings + 1) * segs).reshape(rings + 1, segs)
    i, j = np.meshgrid(np.arange(rings), np.arange(segs), indexing="ij")
    a, b = idx[i, j], idx[i, (j + 1) % segs]
    c, d = idx[i + 1, (j + 1) % segs], idx[i + 1, j]
    # two triangles a quad, outward winding; the poles' degenerate ones dropped
    upper = np.stack([a, c, b], -1)
    lower = np.stack([a, d, c], -1)
    keep_u = (i > 0)[..., None]
    keep_l = (i < rings - 1)[..., None]
    quads = np.concatenate([np.where(keep_u, upper, -1), np.where(keep_l, lower, -1)], -1)
    faces = quads.reshape(-1, 3)
    faces = faces[faces[:, 0] >= 0]
    return v, faces, v.copy()


def _tessellate(shape):
    kind = shape["type"]
    if kind == "rectangle":
        return _rectangle()
    if kind == "cube":
        return _cube()
    if kind == "sphere":
        return _sphere(int(shape.get("sphere_res", 32)))
    raise ValueError(f"the reference has no tessellation of '{kind}'")


def compile_scene(desc):
    """dict of per-triangle float64 arrays: p0, e1, e2 (T, 3), ng (unit
    geometric normal), n0, n1, n2 (shading normals at the corners),
    emission (T, 3), refl (T, 3), alpha (T,), conductor (T,) bool, and
    the camera: cam_to_world (4, 4), tan_half_fov (along x)."""
    parts = {k: [] for k in ("p0", "e1", "e2", "n0", "n1", "n2", "emission", "refl", "alpha",
                             "conductor")}
    for shape in desc["shapes"]:
        v, f, n = _tessellate(shape)
        m = np.asarray(shape["to_world"], dtype=np.float64)
        v = v @ m[:3, :3].T + m[:3, 3]
        n = n @ np.linalg.inv(m[:3, :3])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        if np.linalg.det(m[:3, :3]) < 0:
            f = f[:, ::-1]
        p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        nt = len(f)
        parts["p0"].append(p0)
        parts["e1"].append(p1 - p0)
        parts["e2"].append(p2 - p0)
        for k in range(3):
            parts[f"n{k}"].append(n[f[:, k]])
        bsdf = shape.get("bsdf", {"type": "diffuse"})
        em = shape.get("emitter")
        rad = np.asarray(em["radiance"], dtype=np.float64) if em else np.zeros(3)
        parts["emission"].append(np.tile(rad, (nt, 1)))
        refl = np.asarray(bsdf.get("reflectance", [0.5, 0.5, 0.5]), dtype=np.float64)
        parts["refl"].append(np.tile(refl, (nt, 1)))
        parts["alpha"].append(np.full(nt, float(bsdf.get("alpha", 0.0))))
        parts["conductor"].append(np.full(nt, bsdf["type"] == "roughconductor"))
    out = {k: np.concatenate(x, axis=0) for k, x in parts.items()}
    g = np.cross(out["e1"], out["e2"])
    out["area"] = 0.5 * np.linalg.norm(g, axis=-1)
    out["ng"] = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-20)
    sensor = desc["sensor"]
    out["cam_to_world"] = np.asarray(sensor["to_world"], dtype=np.float64)
    out["tan_half_fov"] = float(np.tan(np.deg2rad(float(sensor.get("fov", 45.0))) / 2))
    return out
