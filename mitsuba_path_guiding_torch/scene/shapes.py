"""Shape tessellation: analytic primitives and mesh loading -> triangle soup.

Counterpart of Mitsuba's src/shapes/ (rectangle, cube, sphere, disk,
obj, ply, serialized): every shape compiles to world-space triangles
at scene-build time; there is no per-shape intersection dispatch.  Analytic
primitives use the same canonical-space conventions as the reference plugins
(unit square [-1,1]^2 at z=0, unit cube [-1,1]^3, unit sphere, unit disk).
"""
from __future__ import annotations

import numpy as np

from mitsuba_path_guiding_torch.scene.animation import deformable_at
from mitsuba_path_guiding_torch.scene.transforms import apply_normals, apply_points


class Mesh:
    """Host-side triangle mesh: vertices (V,3), faces (F,3), optional
    per-vertex normals (V,3), uvs (V,2), and colors (V,3) (reference
    trimesh.h vertex-color channel, used by textures/vertexcolors.cpp)."""

    def __init__(self, vertices, faces, normals=None, uvs=None, colors=None):
        self.vertices = np.asarray(vertices, dtype=np.float64)
        self.faces = np.asarray(faces, dtype=np.int64)
        self.normals = None if normals is None else np.asarray(normals, dtype=np.float64)
        self.uvs = None if uvs is None else np.asarray(uvs, dtype=np.float64)
        self.colors = None if colors is None else np.asarray(colors, dtype=np.float64)

    def transformed(self, m):
        v = apply_points(m, self.vertices)
        n = None if self.normals is None else apply_normals(m, self.normals)
        flipped = np.linalg.det(m[:3, :3]) < 0
        faces = self.faces[:, ::-1] if flipped else self.faces
        return Mesh(v, faces, n, self.uvs, self.colors)

    def flipped(self):
        """Reverse orientation (reference Shape 'flipNormals' property):
        swap winding and negate shading normals."""
        n = None if self.normals is None else -self.normals
        return Mesh(self.vertices, self.faces[:, ::-1], n, self.uvs, self.colors)

    def face_colors(self):
        """Per-face packed vertex colors (F, 9) [c0 c1 c2], or None."""
        if self.colors is None:
            return None
        f = self.faces
        return np.concatenate(
            [self.colors[f[:, 0]], self.colors[f[:, 1]], self.colors[f[:, 2]]],
            axis=-1,
        )

    def face_arrays(self):
        """Per-face (p0, e1, e2, n0, n1, n2, uv0, uv1, uv2) with geometric
        normals where no shading normals exist."""
        v = self.vertices
        f = self.faces
        p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        e1, e2 = p1 - p0, p2 - p0
        gn = np.cross(e1, e2)
        gl = np.linalg.norm(gn, axis=-1, keepdims=True)
        gn = gn / np.maximum(gl, 1e-20)
        if self.normals is not None:
            n0, n1, n2 = (self.normals[f[:, i]] for i in range(3))
        else:
            n0 = n1 = n2 = gn
        if self.uvs is not None:
            uv0, uv1, uv2 = (self.uvs[f[:, i]] for i in range(3))
        else:
            uv0 = uv1 = uv2 = np.zeros((len(f), 2))
        return p0, e1, e2, n0, n1, n2, uv0, uv1, uv2


def make_rectangle():
    """Unit square [-1,1]^2 in the z=0 plane, normal +z
    (reference src/shapes/rectangle.cpp canonical space)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], dtype=np.float64)
    f = np.array([[0, 1, 2], [0, 2, 3]])
    n = np.tile([0.0, 0.0, 1.0], (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    return Mesh(v, f, n, uv)


def make_cube():
    """[-1,1]^3 cube, outward flat normals (reference src/shapes/cube.cpp)."""
    verts, faces, normals = [], [], []
    # each face as its own 4 verts (flat shading)
    axes = [
        ((0, 0, 1), (1, 0, 0), (0, 1, 0)),
        ((0, 0, -1), (0, 1, 0), (1, 0, 0)),
        ((1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((-1, 0, 0), (0, 0, 1), (0, 1, 0)),
        ((0, 1, 0), (0, 0, 1), (1, 0, 0)),
        ((0, -1, 0), (1, 0, 0), (0, 0, 1)),
    ]
    for n, u, v in axes:
        n, u, v = np.array(n, float), np.array(u, float), np.array(v, float)
        base = len(verts)
        for su, sv in [(-1, -1), (1, -1), (1, 1), (-1, 1)]:
            verts.append(n + su * u + sv * v)
            normals.append(n)
        faces += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
    return Mesh(np.array(verts), np.array(faces), np.array(normals))


def make_sphere(res_theta=32, res_phi=64):
    """Unit UV sphere with smooth normals (reference src/shapes/sphere.cpp is
    analytic; tessellation density is configurable via ``sphere_res``)."""
    t = np.linspace(0, np.pi, res_theta + 1)
    p = np.linspace(0, 2 * np.pi, res_phi + 1)[:-1]
    TT, PP = np.meshgrid(t, p, indexing="ij")
    x = np.sin(TT) * np.cos(PP)
    y = np.sin(TT) * np.sin(PP)
    z = np.cos(TT)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    idx = np.arange((res_theta + 1) * res_phi).reshape(res_theta + 1, res_phi)
    faces = []
    for i in range(res_theta):
        for j in range(res_phi):
            a, b = idx[i, j], idx[i, (j + 1) % res_phi]
            c, d = idx[i + 1, (j + 1) % res_phi], idx[i + 1, j]
            # counter-clockwise seen from outside -> outward geometric
            # normals (area emitters emit from the front face)
            if i > 0:
                faces.append([a, c, b])
            if i < res_theta - 1:
                faces.append([a, d, c])
    return Mesh(verts, np.array(faces), verts.copy())


def make_disk(res=64):
    """Unit disk at z=0, normal +z (reference src/shapes/disk.cpp)."""
    ang = np.linspace(0, 2 * np.pi, res + 1)[:-1]
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros(res)], axis=-1)
    verts = np.concatenate([[[0, 0, 0]], rim], axis=0)
    faces = [[0, 1 + i, 1 + (i + 1) % res] for i in range(res)]
    n = np.tile([0.0, 0.0, 1.0], (len(verts), 1))
    return Mesh(verts, np.array(faces), n)


def load_obj(path):
    """Minimal Wavefront OBJ loader (reference src/shapes/obj.cpp; v/vn/vt/f,
    polygon fan triangulation, negative indices)."""
    vs, vns, vts = [], [], []
    out_v, out_n, out_t, faces = [], [], [], []
    cache = {}

    def vertex(tok):
        if tok in cache:
            return cache[tok]
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(vts) + ti
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(vns) + ni
        out_v.append(vs[vi])
        out_t.append(vts[ti] if ti is not None else [0.0, 0.0])
        out_n.append(vns[ni] if ni is not None else None)
        cache[tok] = len(out_v) - 1
        return cache[tok]

    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vn "):
                vns.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                vts.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                toks = line.split()[1:]
                ids = [vertex(t) for t in toks]
                for k in range(1, len(ids) - 1):
                    faces.append([ids[0], ids[k], ids[k + 1]])

    has_normals = all(n is not None for n in out_n) and len(out_n) > 0
    return Mesh(
        np.asarray(out_v),
        np.asarray(faces),
        np.asarray(out_n) if has_normals else None,
        np.asarray(out_t) if vts else None,
    )


def load_ply(path):
    """Minimal binary/ascii PLY loader (reference src/shapes/ply.cpp subset:
    vertex x/y/z[/nx/ny/nz] + face vertex_indices)."""
    with open(path, "rb") as fh:
        header = []
        while True:
            line = fh.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        elements = []  # (name, count, [(type, prop)...])
        cur = None
        for l in header:
            t = l.split()
            if not t:
                continue
            if t[0] == "element":
                cur = (t[1], int(t[2]), [])
                elements.append(cur)
            elif t[0] == "property" and cur is not None:
                if t[1] == "list":
                    cur[2].append(("list", t[2], t[3], t[4]))
                else:
                    cur[2].append((t[1], t[2]))

        type_map = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
            "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
        }
        endian = "<" if "little" in fmt else ">"
        verts = normals = colors = None
        faces = []
        for name, count, props in elements:
            if name == "vertex":
                dt = np.dtype([(p[1], endian + type_map[p[0]]) for p in props])
                if fmt == "ascii":
                    rows = [fh.readline().split() for _ in range(count)]
                    arr = np.array([[float(x) for x in r] for r in rows])
                    data = {p[1]: arr[:, i] for i, p in enumerate(props)}
                else:
                    raw = np.frombuffer(fh.read(count * dt.itemsize), dtype=dt)
                    data = {p[1]: raw[p[1]] for p in props}
                verts = np.stack([data["x"], data["y"], data["z"]], axis=-1).astype(np.float64)
                if "nx" in data:
                    normals = np.stack([data["nx"], data["ny"], data["nz"]], axis=-1).astype(np.float64)
                if "red" in data:
                    # uchar colors are sRGB bytes (ply.cpp convention)
                    colors = np.stack(
                        [data["red"], data["green"], data["blue"]], axis=-1
                    ).astype(np.float64)
                    if colors.max() > 1.0:
                        colors = colors / 255.0
            elif name == "face":
                lp = props[0]
                cdt = np.dtype(endian + type_map[lp[1]])
                idt = np.dtype(endian + type_map[lp[2]])
                if fmt == "ascii":
                    for _ in range(count):
                        t = [int(x) for x in fh.readline().split()]
                        ids = t[1 : 1 + t[0]]
                        for k in range(1, len(ids) - 1):
                            faces.append([ids[0], ids[k], ids[k + 1]])
                else:
                    for _ in range(count):
                        (n,) = np.frombuffer(fh.read(cdt.itemsize), dtype=cdt)
                        ids = np.frombuffer(fh.read(int(n) * idt.itemsize), dtype=idt)
                        for k in range(1, len(ids) - 1):
                            faces.append([int(ids[0]), int(ids[k]), int(ids[k + 1])])
    return Mesh(verts, np.asarray(faces), normals, colors=colors)


def load_serialized(path, index: int = 0):
    """Mitsuba .serialized mesh format (reference
    src/librender/trimesh.cpp:176-240 loadCompressed): little-endian
    uint16 magic 0x041C + uint16 version (3/4), then one zlib stream per
    mesh holding uint32 flags, [v4: null-terminated name], uint64
    vertex/triangle counts, positions, optional normals/uvs/colors, and
    uint32 triangle indices.  Multi-mesh files index via the uint64
    offset table before the trailing uint32 mesh count."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<HH", data, 0)
    if magic != 0x041C:
        raise ValueError(f"{path}: bad .serialized magic {magic:#x}")
    if version not in (3, 4):
        raise ValueError(f"{path}: unsupported version {version}")
    offset = 4
    if index != 0:
        (count,) = struct.unpack_from("<I", data, len(data) - 4)
        if not 0 <= index < count:
            raise ValueError(f"{path}: mesh index {index} out of range ({count})")
        if version == 4:
            (off,) = struct.unpack_from(
                "<Q", data, len(data) - 8 * (count - index) - 4
            )
        else:
            (off,) = struct.unpack_from(
                "<I", data, len(data) - 4 * (count - index + 1)
            )
        offset = off + 4  # skip the per-mesh header
    # decompressobj tolerates the next mesh's bytes after the stream end
    raw = zlib.decompressobj().decompress(data[offset:])
    pos = 0
    (flags,) = struct.unpack_from("<I", raw, pos); pos += 4
    if version == 4:
        end = raw.index(b"\0", pos)
        pos = end + 1
    vc, tc = struct.unpack_from("<QQ", raw, pos); pos += 16
    double = bool(flags & 0x2000)
    fsize, ftype = (8, "<f8") if double else (4, "<f4")

    def take(n):
        nonlocal pos
        out = np.frombuffer(raw, dtype=ftype, count=n, offset=pos).astype(np.float64)
        pos += n * fsize
        return out

    verts = take(vc * 3).reshape(vc, 3)
    normals = take(vc * 3).reshape(vc, 3) if flags & 0x0001 else None
    uvs = take(vc * 2).reshape(vc, 2) if flags & 0x0002 else None
    colors = take(vc * 3).reshape(vc, 3) if flags & 0x0008 else None
    faces = np.frombuffer(raw, dtype="<u4", count=tc * 3, offset=pos).reshape(tc, 3)
    return Mesh(verts, faces.astype(np.int64), normals, uvs, colors)


def save_serialized(path, meshes):
    """Writer for tests/converters (v4, single precision)."""
    import struct
    import zlib

    blobs, offsets = [], []
    cursor = 0
    for mesh in meshes:
        flags = 0x1000 | (0x0001 if mesh.normals is not None else 0) | (
            0x0002 if mesh.uvs is not None else 0
        )
        body = struct.pack("<I", flags) + b"mesh\0"
        body += struct.pack("<QQ", len(mesh.vertices), len(mesh.faces))
        body += mesh.vertices.astype("<f4").tobytes()
        if mesh.normals is not None:
            body += mesh.normals.astype("<f4").tobytes()
        if mesh.uvs is not None:
            body += mesh.uvs.astype("<f4").tobytes()
        body += mesh.faces.astype("<u4").tobytes()
        blob = struct.pack("<HH", 0x041C, 4) + zlib.compress(body)
        offsets.append(cursor)
        blobs.append(blob)
        cursor += len(blob)
    out = b"".join(blobs)
    out += b"".join(struct.pack("<Q", o) for o in offsets)
    out += struct.pack("<I", len(blobs))
    with open(path, "wb") as f:
        f.write(out)


def make_cylinder(p0=(0, 0, 0), p1=(0, 0, 1), radius=1.0, res=32):
    """Open-ended cylinder from p0 to p1 (reference src/shapes/cylinder.cpp
    canonical shape), tessellated with exact per-vertex shading normals —
    every analytic primitive becomes triangles for the single wavefront
    intersector (in place of a per-shape rayIntersect)."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    axis = axis / max(length, 1e-12)
    # build an orthonormal frame around the axis
    up = np.array([1.0, 0.0, 0.0]) if abs(axis[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    x = np.cross(up, axis)
    x /= np.linalg.norm(x)
    y = np.cross(axis, x)
    phi = np.arange(res) / res * 2.0 * np.pi
    ring = (np.cos(phi)[:, None] * x + np.sin(phi)[:, None] * y) * radius
    v = np.concatenate([p0 + ring, p1 + ring], axis=0)
    n = np.concatenate([ring, ring], axis=0) / radius
    uv = np.stack(
        [np.concatenate([phi, phi]) / (2 * np.pi),
         np.concatenate([np.zeros(res), np.ones(res)])], axis=-1
    )
    f = []
    for i in range(res):
        j = (i + 1) % res
        f.append([i, j, res + j])
        f.append([i, res + j, res + i])
    return Mesh(v, np.asarray(f), n, uv)


def make_heightfield(heights, scale=1.0, shading_normals=True):
    """Height field over [-1,1]^2 (reference src/shapes/heightfield.cpp:
    z = scale * h(x, y) on a regular grid; the 2D quadtree accelerator is
    unnecessary once the field is triangulated into the global BVH)."""
    hmap = np.asarray(heights, dtype=np.float64) * scale
    H, W = hmap.shape
    xs = np.linspace(-1.0, 1.0, W)
    ys = np.linspace(-1.0, 1.0, H)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    v = np.stack([X, Y, hmap], axis=-1).reshape(-1, 3)
    uv = np.stack(
        [np.tile((xs + 1) / 2, H), np.repeat((ys + 1) / 2, W)], axis=-1
    )
    f = []
    for r in range(H - 1):
        for c in range(W - 1):
            i = r * W + c
            f.append([i, i + 1, i + W + 1])
            f.append([i, i + W + 1, i + W])
    n = None
    if shading_normals:
        gy, gx = np.gradient(hmap, ys, xs)
        n = np.stack([-gx, -gy, np.ones_like(hmap)], axis=-1).reshape(-1, 3)
        n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return Mesh(v, np.asarray(f), n, uv)


def load_hair(path):
    """Read the reference's .hair formats (src/shapes/hair.cpp:76-108):
    ASCII lines of vertex coordinates with blank lines separating fibers,
    or "BINARY_HAIR" + uint32 count + float32 xyz stream where a +inf x
    marks a new fiber.  Returns (vertices list-of-arrays per fiber)."""
    with open(path, "rb") as fh:
        head = fh.read(11)
    fibers, cur = [], []
    if head == b"BINARY_HAIR":
        import struct

        with open(path, "rb") as fh:
            fh.read(11)
            (count,) = struct.unpack("<I", fh.read(4))
            data = np.frombuffer(fh.read(), dtype="<f4")
        i = 0
        while i + 2 < len(data):
            if not np.isfinite(data[i]):
                if cur:
                    fibers.append(np.asarray(cur))
                cur = []
                i += 1
                continue
            cur.append(data[i : i + 3].astype(np.float64))
            i += 3
    else:
        for line in open(path):
            line = line.strip()
            if not line:
                if cur:
                    fibers.append(np.asarray(cur))
                cur = []
                continue
            cur.append(np.array([float(x) for x in line.split()]))
    if cur:
        fibers.append(np.asarray(cur))
    return [f for f in fibers if len(f) >= 2]


def make_hair(props):
    """Hair plugin (src/shapes/hair.cpp): fibers -> per-segment tubes.

    The reference intersects analytic capsule segments through a custom
    kd-tree; here each segment becomes a ``sides``-gon tube so hair rides
    the same wavefront BVH as everything else.  ``reduction`` keeps a
    random subset of fibers with enlarged radius (hair.cpp Cook et al.
    fast-preview trick)."""
    if "fibers" in props:
        fibers = [np.asarray(f, dtype=np.float64) for f in props["fibers"]]
    else:
        fibers = load_hair(props["filename"])
    radius = float(props.get("radius", 0.025))
    reduction = float(props.get("reduction", 0.0))
    sides = int(props.get("sides", 4))
    if reduction > 0.0 and len(fibers) > 1:
        rng = np.random.default_rng(int(props.get("seed", 0)))
        keep = max(1, int(len(fibers) * (1.0 - reduction)))
        idx = rng.choice(len(fibers), size=keep, replace=False)
        fibers = [fibers[i] for i in sorted(idx)]
        radius = radius / np.sqrt(max(1.0 - reduction, 1e-3))
    vs, fs, ns = [], [], []
    base = 0
    phi = np.arange(sides) / sides * 2.0 * np.pi
    cphi, sphi = np.cos(phi), np.sin(phi)
    for fib in fibers:
        # one ring per vertex, oriented by the averaged segment tangent
        t = np.diff(fib, axis=0)
        t = t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
        tv = np.concatenate([t[:1], 0.5 * (t[1:] + t[:-1]), t[-1:]], axis=0)
        tv /= np.maximum(np.linalg.norm(tv, axis=-1, keepdims=True), 1e-12)
        up = np.where(np.abs(tv[:, :1]) < 0.9, [[1.0, 0, 0]], [[0, 1.0, 0]])
        x = np.cross(up, tv)
        x /= np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
        y = np.cross(tv, x)
        ring_n = cphi[None, :, None] * x[:, None] + sphi[None, :, None] * y[:, None]
        ring = fib[:, None] + ring_n * radius
        V = len(fib)
        vs.append(ring.reshape(-1, 3))
        ns.append(ring_n.reshape(-1, 3))
        for s in range(V - 1):
            for i in range(sides):
                j = (i + 1) % sides
                a = base + s * sides + i
                b = base + s * sides + j
                c = base + (s + 1) * sides + j
                d = base + (s + 1) * sides + i
                fs.append([a, b, c])
                fs.append([a, c, d])
        base += V * sides
    return Mesh(np.concatenate(vs), np.asarray(fs), np.concatenate(ns), None)


SHAPE_BUILDERS = {
    "rectangle": lambda props: make_rectangle(),
    "cube": lambda props: make_cube(),
    "sphere": lambda props: make_sphere(
        props.get("sphere_res", 32), 2 * props.get("sphere_res", 32)
    ),
    "disk": lambda props: make_disk(props.get("disk_res", 64)),
    "obj": lambda props: load_obj(props["filename"]),
    "ply": lambda props: load_ply(props["filename"]),
    "trimesh": lambda props: Mesh(
        props["vertices"], props["faces"], props.get("normals"),
        props.get("uvs"), props.get("colors"),
    ),
    "serialized": lambda props: load_serialized(
        props["filename"], int(props.get("shape_index", 0))
    ),
    "cylinder": lambda props: make_cylinder(
        props.get("p0", (0, 0, 0)), props.get("p1", (0, 0, 1)),
        float(props.get("radius", 1.0)), int(props.get("cyl_res", 32)),
    ),
    "heightfield": lambda props: make_heightfield(
        _heightfield_data(props), float(props.get("scale", 1.0)),
        bool(props.get("shading_normals", True)),
    ),
    "hair": make_hair,
    # keyframed vertex animation (Mitsuba's shapes/deformable.cpp); built
    # directly it bakes at props["time"] (default 0), scene_at_time() bakes
    # other times
    "deformable": lambda props: Mesh(
        deformable_at(props, float(props.get("time", 0.0)))["vertices"],
        props["faces"], props.get("normals"), props.get("uvs"),
    ),
}


def _heightfield_data(props):
    if "heights" in props:
        return np.asarray(props["heights"], dtype=np.float64)
    from mitsuba_path_guiding_torch.util import _read

    img = _read(props["filename"])
    return img.mean(axis=-1) if img.ndim == 3 else img


def vertex_curvature(mesh: Mesh, kind: str = "mean") -> np.ndarray:
    """Per-vertex discrete curvature (reference src/textures/curvature.cpp,
    which visualizes principal-curvature-derived quantities): ``gaussian``
    = angle deficit / mixed area (Gauss-Bonnet), ``mean`` = half the norm
    of the cotangent Laplacian per mixed area, signed by the normal
    direction.  Host-side, vectorized numpy over faces."""
    v = mesh.vertices
    f = mesh.faces
    nv = len(v)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)

    def angles(a, b, c):
        u, w = b - a, c - a
        cosang = np.einsum("ij,ij->i", u, w) / np.maximum(
            np.linalg.norm(u, axis=-1) * np.linalg.norm(w, axis=-1), 1e-20
        )
        return np.arccos(np.clip(cosang, -1.0, 1.0))

    ang0, ang1 = angles(p0, p1, p2), angles(p1, p2, p0)
    ang2 = np.pi - ang0 - ang1
    a_mix = np.zeros(nv)
    for i in range(3):
        np.add.at(a_mix, f[:, i], area / 3.0)
    a_mix = np.maximum(a_mix, 1e-12)

    if kind == "gaussian":
        asum = np.zeros(nv)
        for i, ang in enumerate((ang0, ang1, ang2)):
            np.add.at(asum, f[:, i], ang)
        return (2.0 * np.pi - asum) / a_mix

    # cotangent Laplacian: L(v_i) = 0.5 * sum_j (cot a + cot b)(v_j - v_i)
    cot = lambda ang: np.cos(ang) / np.maximum(np.sin(ang), 1e-9)
    c0, c1, c2 = cot(ang0), cot(ang1), cot(ang2)
    lap = np.zeros((nv, 3))
    # edge (1,2) is opposite vertex 0 etc.
    for (i, j, copp) in ((1, 2, c0), (2, 0, c1), (0, 1, c2)):
        d = v[f[:, j]] - v[f[:, i]]
        np.add.at(lap, f[:, i], 0.5 * copp[:, None] * d)
        np.add.at(lap, f[:, j], -0.5 * copp[:, None] * d)
    # Meyer et al.: mean-curvature normal K = L / A_mixed with ||K|| = 2H
    hvec = lap / (2.0 * a_mix[:, None])
    h = np.linalg.norm(hvec, axis=-1)
    # sign: H > 0 where the Laplacian points against the vertex normal
    if mesh.normals is not None:
        nrm = mesh.normals
    else:
        nrm = np.zeros((nv, 3))
        fn = np.cross(p1 - p0, p2 - p0)
        for i in range(3):
            np.add.at(nrm, f[:, i], fn)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-20)
    sign = -np.sign(np.einsum("ij,ij->i", hvec, nrm))
    return sign * h


def curvature_colors(mesh: Mesh, kind: str = "mean", scale: float = 1.0) -> np.ndarray:
    """Colormapped per-vertex curvature (V,3): positive -> red, negative ->
    blue, zero -> white (curvature.cpp's display convention)."""
    k = np.tanh(vertex_curvature(mesh, kind) * scale)
    pos = np.clip(k, 0.0, 1.0)
    neg = np.clip(-k, 0.0, 1.0)
    col = np.stack([1.0 - neg, 1.0 - pos - neg, 1.0 - pos], axis=-1)
    return np.clip(col, 0.0, 1.0)
