"""Pure-Python OpenVDB (.vdb) codec: read + write of float grids.

A copy of the JAX package's numpy-only scene/vdb.py.  The path-guiding
fork's vdbvolume.cpp loads an OpenVDB float grid through the OpenVDB
library; without the bindings, this module is a from-scratch
implementation of the OpenVDB archive format itself — enough of it to
round-trip dense float volumes and to ingest externally produced files
within the documented subset:

  - archive versions 220..228 (the OpenVDB 4.x-9.x era layout)
  - standard ``Tree_float_5_4_3`` grids (Root -> Internal 32^3 ->
    Internal 16^3 -> Leaf 8^3), float or half voxel payloads
  - per-node value arrays: uncompressed, ZIP (zlib), and the
    active-mask selective compression codes 0-6 (io/Compression.h)
  - transforms: UniformScaleMap / ScaleMap / TranslationMap /
    UniformScaleTranslateMap / ScaleTranslateMap / AffineMap
  - rejected with a clear error: Blosc-compressed files (bit 4 of the
    compression flags), point-data grids, non-float grid types

The writer emits archive version 224, ``hasGridOffsets=0`` (pure stream
order), compression flags 0 (none) or 1 (zip) — files our own reader and
the conversion pipeline consume.  ``vdb_to_dense`` in scene/volume.py
prefers real OpenVDB bindings when importable and falls back to this
module otherwise.
"""
from __future__ import annotations

import struct
import uuid as _uuid
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = 0x56444220
# io/Compression.h flags
COMPRESS_NONE = 0
COMPRESS_ZIP = 1
COMPRESS_ACTIVE_MASK = 2
COMPRESS_BLOSC = 4
# active-mask metadata codes (io/Compression.h)
NO_MASK_OR_INACTIVE_VALS = 0
NO_MASK_AND_MINUS_BG = 1
NO_MASK_AND_ONE_INACTIVE_VAL = 2
MASK_AND_NO_INACTIVE_VALS = 3
MASK_AND_ONE_INACTIVE_VAL = 4
MASK_AND_TWO_INACTIVE_VALS = 5
NO_MASK_AND_ALL_VALS = 6

# tree dimensions: Root -> Node(log2=5) -> Node(log2=4) -> Leaf(log2=3)
L0_LOG2, L1_LOG2, LEAF_LOG2 = 5, 4, 3
L0_DIM, L1_DIM, LEAF_DIM = 1 << L0_LOG2, 1 << L1_LOG2, 1 << LEAF_LOG2
L0_TOTAL = L0_LOG2 + L1_LOG2 + LEAF_LOG2   # 12: internal-0 spans 4096^3
L1_TOTAL = L1_LOG2 + LEAF_LOG2             # 7:  internal-1 spans 128^3
FILE_VERSION = 224
PER_GRID_COMPRESSION_VERSION = 223  # per-grid flags echoed before metadata
BOOST_UUID_VERSION = 224            # 36-char uuid in the header


class _R:
    """Little-endian stream reader over bytes."""

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def bytes(self, n: int) -> bytes:
        b = self.d[self.o : self.o + n]
        if len(b) != n:
            raise ValueError("vdb: truncated file")
        self.o += n
        return b

    def u8(self) -> int:
        return self.bytes(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.bytes(4))[0]

    def i32x3(self) -> Tuple[int, int, int]:
        return struct.unpack("<3i", self.bytes(12))

    def i64(self) -> int:
        return struct.unpack("<q", self.bytes(8))[0]

    def f64(self, n: int = 1):
        v = struct.unpack(f"<{n}d", self.bytes(8 * n))
        return v[0] if n == 1 else v

    def string(self) -> str:
        return self.bytes(self.u32()).decode("utf-8", "replace")


def _w_string(out: bytearray, s: str) -> None:
    b = s.encode()
    out += struct.pack("<I", len(b)) + b


@dataclass
class VdbGrid:
    """One float grid: dense values over an index-space bounding box."""

    name: str
    data: np.ndarray                  # (nx, ny, nz) float32, index order
    origin: Tuple[int, int, int]      # index-space coordinate of data[0,0,0]
    voxel_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    background: float = 0.0
    grid_class: str = "fog volume"
    metadata: Dict[str, object] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _read_meta_value(typ: str, raw: bytes):
    if typ == "string":
        # string metadata payloads carry their own length prefix
        n = struct.unpack("<I", raw[:4])[0]
        return raw[4 : 4 + n].decode("utf-8", "replace")
    if typ == "int32":
        return struct.unpack("<i", raw)[0]
    if typ == "int64":
        return struct.unpack("<q", raw)[0]
    if typ == "float":
        return struct.unpack("<f", raw)[0]
    if typ == "double":
        return struct.unpack("<d", raw)[0]
    if typ == "bool":
        return raw[0] != 0
    if typ == "vec3i":
        return struct.unpack("<3i", raw)
    if typ == "vec3s":
        return struct.unpack("<3f", raw)
    if typ == "vec3d":
        return struct.unpack("<3d", raw)
    return raw  # unknown types stay opaque


def _read_metamap(r: _R) -> Dict[str, object]:
    out = {}
    for _ in range(r.u32()):
        name = r.string()
        typ = r.string()
        raw = r.bytes(r.u32())
        out[name] = _read_meta_value(typ, raw)
    return out


def _read_transform(r: _R):
    map_type = r.string()
    one = (1.0, 1.0, 1.0)
    zero = (0.0, 0.0, 0.0)
    if map_type in ("UniformScaleMap", "ScaleMap"):
        # ScaleMap payload: scale, voxelSize, scaleInv, invScaleSqr,
        # invTwiceScale (5 x Vec3d)
        vals = r.f64(15)
        return tuple(vals[0:3]), zero
    if map_type == "TranslationMap":
        return one, tuple(r.f64(3))
    if map_type in ("UniformScaleTranslateMap", "ScaleTranslateMap"):
        # translation, then the 5 scale vectors
        vals = r.f64(18)
        return tuple(vals[3:6]), tuple(vals[0:3])
    if map_type == "AffineMap":
        m = np.array(r.f64(16)).reshape(4, 4)
        return tuple(np.diag(m)[:3]), tuple(m[3, :3])
    raise ValueError(f"vdb: unsupported transform map '{map_type}'")


def _read_compressed_array(r: _R, count: int, compression: int,
                           file_version: int, value_mask: Optional[np.ndarray],
                           background: float, half: bool) -> np.ndarray:
    """io::readCompressedValues — one per-node value array."""
    dtype = np.dtype("<f2") if half else np.dtype("<f4")
    n_read = count
    metadata = NO_MASK_AND_ALL_VALS
    inactive1 = inactive0 = background
    selection = None
    if file_version >= 222 and (compression & COMPRESS_ACTIVE_MASK):
        metadata = r.u8()
        if metadata in (NO_MASK_AND_ONE_INACTIVE_VAL,
                        MASK_AND_ONE_INACTIVE_VAL,
                        MASK_AND_TWO_INACTIVE_VALS):
            inactive0 = np.frombuffer(r.bytes(dtype.itemsize), dtype)[0]
        if metadata == MASK_AND_TWO_INACTIVE_VALS:
            inactive1 = np.frombuffer(r.bytes(dtype.itemsize), dtype)[0]
        if metadata in (MASK_AND_NO_INACTIVE_VALS, MASK_AND_ONE_INACTIVE_VAL,
                        MASK_AND_TWO_INACTIVE_VALS):
            # selection mask flags inactive voxels set to inactive1
            selection = np.unpackbits(
                np.frombuffer(r.bytes(count // 8), np.uint8), bitorder="little"
            ).astype(bool)
        if metadata != NO_MASK_AND_ALL_VALS and value_mask is not None:
            n_read = int(value_mask.sum())

    if compression & COMPRESS_BLOSC:
        raise ValueError(
            "vdb: Blosc-compressed file — re-save with compression='zip' or "
            "'none' (e.g. `vdb_print`/Houdini), or install openvdb bindings"
        )
    if compression & COMPRESS_ZIP:
        nbytes = r.i64()
        if nbytes <= 0:  # zipToStream stores raw when zip won't shrink
            raw = r.bytes(-nbytes if nbytes < 0 else n_read * dtype.itemsize)
        else:
            raw = zlib.decompress(r.bytes(nbytes))
    else:
        raw = r.bytes(n_read * dtype.itemsize)
    vals = np.frombuffer(raw, dtype, n_read).astype(np.float32)

    if metadata == NO_MASK_AND_ALL_VALS or value_mask is None:
        out = vals
        if out.shape[0] != count:
            raise ValueError("vdb: value array size mismatch")
    else:
        out = np.full(count, float(inactive0), np.float32)
        if metadata == NO_MASK_AND_MINUS_BG:
            out[:] = -background
        idx = np.nonzero(value_mask)[0]
        out[idx[: vals.shape[0]]] = vals
        if selection is not None:
            out[selection[:count]] = float(inactive1)
    return out


def _read_mask(r: _R, dim: int) -> np.ndarray:
    nbits = dim ** 3
    return np.unpackbits(
        np.frombuffer(r.bytes(nbits // 8), np.uint8), bitorder="little"
    ).astype(bool)


@dataclass
class _Leaf:
    origin: Tuple[int, int, int]
    mask: np.ndarray
    values: Optional[np.ndarray] = None


def _read_internal(r: _R, origin, level: int, compression: int,
                   file_version: int, background: float, half: bool,
                   leaves: List[_Leaf], tiles: list) -> None:
    dim = L0_DIM if level == 0 else L1_DIM
    total = L0_TOTAL if level == 0 else L1_TOTAL
    child_total = L1_TOTAL if level == 0 else LEAF_LOG2
    child_mask = _read_mask(r, dim)
    value_mask = _read_mask(r, dim)
    values = _read_compressed_array(r, dim ** 3, compression, file_version,
                                    value_mask, background, half)
    # active tiles at this level
    for idx in np.nonzero(value_mask & ~child_mask)[0]:
        tiles.append((_offset_to_coord(idx, dim, total, origin),
                      1 << child_total, float(values[idx])))
    for idx in np.nonzero(child_mask)[0]:
        corigin = _offset_to_coord(idx, dim, total, origin)
        if level == 0:
            _read_internal(r, corigin, 1, compression, file_version,
                           background, half, leaves, tiles)
        else:
            leaves.append(_Leaf(corigin, _read_mask(r, LEAF_DIM)))


def _offset_to_coord(n: int, dim: int, total: int, origin) -> Tuple[int, int, int]:
    # InternalNode::offsetToLocalCoord: x-major nesting (x*dim + y)*dim + z
    z = n % dim
    y = (n // dim) % dim
    x = n // (dim * dim)
    child = 1 << (total - (L0_LOG2 if dim == L0_DIM else L1_LOG2))
    return (origin[0] + x * child, origin[1] + y * child,
            origin[2] + z * child)


def read_vdb(path: str) -> List[VdbGrid]:
    """Parse a .vdb archive into dense grids (subset in module docstring)."""
    with open(path, "rb") as f:
        r = _R(f.read())
    if r.i64() != MAGIC:
        raise ValueError(f"{path}: not an OpenVDB file")
    file_version = r.u32()
    if not (218 <= file_version <= 230):
        raise ValueError(f"{path}: unsupported archive version {file_version}")
    r.u32(), r.u32()  # library major/minor
    has_offsets = r.u8() != 0
    if file_version >= 220:
        compression = r.u32()
    else:
        compression = COMPRESS_ZIP if r.u8() else COMPRESS_NONE
    if file_version >= BOOST_UUID_VERSION:
        r.bytes(36)  # ascii uuid
    _read_metamap(r)  # file-level metadata
    n_grids = r.u32()

    grids: List[VdbGrid] = []
    for _ in range(n_grids):
        name = r.string()
        grid_type = r.string()
        instance_parent = r.string() if file_version >= 222 else ""
        if instance_parent:
            raise ValueError(f"{path}: grid instancing not supported")
        grid_pos = end_pos = None
        if has_offsets:
            grid_pos, _, end_pos = r.i64(), r.i64(), r.i64()
            r.o = grid_pos
        if file_version >= PER_GRID_COMPRESSION_VERSION:
            compression = r.u32()
        meta = _read_metamap(r)
        half = bool(meta.get("is_saved_as_half_float", False))
        if "float" not in grid_type:
            if has_offsets:  # skippable: jump to the next grid
                r.o = end_pos
                continue
            raise ValueError(f"{path}: non-float grid '{grid_type}'")
        voxel, translate = _read_transform(r)

        if r.u32() != 1:
            raise ValueError(f"{path}: expected one tree buffer")
        dtype = np.dtype("<f2") if half else np.dtype("<f4")
        background = float(np.frombuffer(r.bytes(dtype.itemsize), dtype)[0])
        n_tiles = r.u32()
        n_children = r.u32()
        tiles: list = []
        leaves: List[_Leaf] = []
        for _ in range(n_tiles):
            origin = r.i32x3()
            val = float(np.frombuffer(r.bytes(dtype.itemsize), dtype)[0])
            active = r.u8() != 0
            if active:
                tiles.append((origin, 1 << L0_TOTAL, val))
        for _ in range(n_children):
            origin = r.i32x3()
            _read_internal(r, origin, 0, compression, file_version,
                           background, half, leaves, tiles)
        # leaf buffers, depth-first order matching topology
        for leaf in leaves:
            leaf.values = _read_compressed_array(
                r, LEAF_DIM ** 3, compression, file_version, leaf.mask,
                background, half)
        grids.append(_assemble_dense(name, background, voxel, translate,
                                     tiles, leaves, meta))
    return grids


def _assemble_dense(name, background, voxel, translate, tiles, leaves,
                    meta) -> VdbGrid:
    boxes = []
    for origin, size, _ in tiles:
        boxes.append((origin, (origin[0] + size, origin[1] + size,
                               origin[2] + size)))
    for leaf in leaves:
        o = leaf.origin
        boxes.append((o, (o[0] + LEAF_DIM, o[1] + LEAF_DIM, o[2] + LEAF_DIM)))
    if not boxes:
        return VdbGrid(name, np.zeros((1, 1, 1), np.float32), (0, 0, 0),
                       voxel, translate, background, metadata=meta)
    lo = np.min([b[0] for b in boxes], axis=0)
    hi = np.max([b[1] for b in boxes], axis=0)
    data = np.full(tuple(hi - lo), background, np.float32)
    for origin, size, val in tiles:
        s = np.asarray(origin) - lo
        data[s[0]:s[0]+size, s[1]:s[1]+size, s[2]:s[2]+size] = val
    for leaf in leaves:
        s = np.asarray(leaf.origin) - lo
        vals = leaf.values.reshape(LEAF_DIM, LEAF_DIM, LEAF_DIM)
        data[s[0]:s[0]+LEAF_DIM, s[1]:s[1]+LEAF_DIM, s[2]:s[2]+LEAF_DIM] = vals
    cls = meta.get("class", "fog volume")
    return VdbGrid(name, data, tuple(int(v) for v in lo), voxel, translate,
                   background, grid_class=cls, metadata=meta)


# ---------------------------------------------------------------------------
# writing (archive version 224, stream-ordered, no grid offsets)
# ---------------------------------------------------------------------------


def _w_meta(out: bytearray, meta: Dict[str, object]) -> None:
    out += struct.pack("<I", len(meta))
    for k, v in meta.items():
        _w_string(out, k)
        if isinstance(v, bool):
            _w_string(out, "bool")
            payload = bytes([1 if v else 0])
        elif isinstance(v, int):
            _w_string(out, "int64")
            payload = struct.pack("<q", v)
        elif isinstance(v, float):
            _w_string(out, "double")
            payload = struct.pack("<d", v)
        else:
            _w_string(out, "string")
            b = str(v).encode()
            payload = struct.pack("<I", len(b)) + b
        out += struct.pack("<I", len(payload)) + payload


def _w_array(out: bytearray, vals: np.ndarray, compression: int) -> None:
    raw = np.asarray(vals, "<f4").tobytes()
    if compression & COMPRESS_ZIP:
        comp = zlib.compress(raw, 6)
        if len(comp) < len(raw):
            out += struct.pack("<q", len(comp)) + comp
        else:
            out += struct.pack("<q", -len(raw)) + raw
    else:
        out += raw


def _w_mask(out: bytearray, mask: np.ndarray) -> None:
    out += np.packbits(mask.astype(np.uint8), bitorder="little").tobytes()


def write_vdb(path: str, grids: List[VdbGrid],
              compression: str = "zip") -> None:
    """Serialize dense grids as a standard 5-4-3 float-tree archive."""
    flags = {"none": COMPRESS_NONE, "zip": COMPRESS_ZIP}[compression]
    out = bytearray()
    out += struct.pack("<q", MAGIC)
    out += struct.pack("<I", FILE_VERSION)
    out += struct.pack("<II", 8, 1)          # library version
    out += bytes([0])                        # hasGridOffsets = false
    out += struct.pack("<I", flags)
    out += str(_uuid.uuid4()).encode()[:36]
    _w_meta(out, {})                         # file metadata
    out += struct.pack("<I", len(grids))
    for g in grids:
        _w_string(out, g.name)
        _w_string(out, "Tree_float_5_4_3")
        _w_string(out, "")                   # no instance parent
        out += struct.pack("<I", flags)      # per-grid compression echo
        _w_meta(out, {"name": g.name, "class": g.grid_class,
                      "is_saved_as_half_float": False})
        # transform: UniformScaleTranslateMap payload (translation + the
        # five scale vectors — see _read_transform)
        _w_string(out, "UniformScaleTranslateMap")
        s = np.asarray(g.voxel_size, np.float64)
        t = np.asarray(g.translation, np.float64)
        vecs = [t, s, s, 1.0 / s, 1.0 / (s * s), 0.5 / s]
        out += struct.pack("<18d", *np.concatenate(vecs))
        _write_tree(out, g, flags)
    with open(path, "wb") as f:
        f.write(bytes(out))


def _write_tree(out: bytearray, g: VdbGrid, flags: int) -> None:
    out += struct.pack("<I", 1)  # buffer count
    out += struct.pack("<f", g.background)
    data, origin = g.data, np.asarray(g.origin)
    shape = np.asarray(data.shape)
    # carve into leaf nodes grouped by their internal-node ancestry
    lo_leaf = (origin // LEAF_DIM) * LEAF_DIM
    hi_leaf = ((origin + shape + LEAF_DIM - 1) // LEAF_DIM) * LEAF_DIM
    # group leaves under level-0 internal nodes (span 4096) then level-1 (128)
    l0_nodes: Dict[Tuple, Dict[Tuple, Dict[Tuple, np.ndarray]]] = {}
    for lx in range(lo_leaf[0], hi_leaf[0], LEAF_DIM):
        for ly in range(lo_leaf[1], hi_leaf[1], LEAF_DIM):
            for lz in range(lo_leaf[2], hi_leaf[2], LEAF_DIM):
                block = np.full((LEAF_DIM,) * 3, g.background, np.float32)
                s = np.maximum([lx, ly, lz], origin)
                e = np.minimum([lx + LEAF_DIM, ly + LEAF_DIM, lz + LEAF_DIM],
                               origin + shape)
                if (s >= e).any():
                    continue
                src = data[s[0]-origin[0]:e[0]-origin[0],
                           s[1]-origin[1]:e[1]-origin[1],
                           s[2]-origin[2]:e[2]-origin[2]]
                if not np.any(src != g.background):
                    continue
                block[s[0]-lx:e[0]-lx, s[1]-ly:e[1]-ly, s[2]-lz:e[2]-lz] = src
                k0 = (lx >> L0_TOTAL, ly >> L0_TOTAL, lz >> L0_TOTAL)
                k1 = (lx >> L1_TOTAL, ly >> L1_TOTAL, lz >> L1_TOTAL)
                l0_nodes.setdefault(k0, {}).setdefault(k1, {})[
                    (lx, ly, lz)] = block

    out += struct.pack("<I", 0)              # root tiles
    out += struct.pack("<I", len(l0_nodes))  # root children
    leaf_order: List[np.ndarray] = []
    for k0, l1_nodes in sorted(l0_nodes.items()):
        o0 = tuple(c << L0_TOTAL for c in k0)
        out += struct.pack("<3i", *o0)
        child_mask = np.zeros(L0_DIM ** 3, bool)
        for k1 in l1_nodes:
            local = [((k1[i] << L1_TOTAL) - o0[i]) >> L1_TOTAL
                     for i in range(3)]
            child_mask[(local[0] * L0_DIM + local[1]) * L0_DIM + local[2]] = True
        _w_mask(out, child_mask)
        _w_mask(out, np.zeros(L0_DIM ** 3, bool))          # value mask
        _w_array(out, np.full(L0_DIM ** 3, g.background, np.float32), flags)
        for k1, leaves in sorted(l1_nodes.items()):
            o1 = tuple(c << L1_TOTAL for c in k1)
            cmask = np.zeros(L1_DIM ** 3, bool)
            for lf in leaves:
                local = [((lf[i] - o1[i]) >> LEAF_LOG2) for i in range(3)]
                cmask[(local[0] * L1_DIM + local[1]) * L1_DIM + local[2]] = True
            _w_mask(out, cmask)
            _w_mask(out, np.zeros(L1_DIM ** 3, bool))
            _w_array(out, np.full(L1_DIM ** 3, g.background, np.float32),
                     flags)
            for lf, block in sorted(leaves.items()):
                _w_mask(out, np.ones(LEAF_DIM ** 3, bool))  # leaf value mask
                leaf_order.append(block)
    for block in leaf_order:
        _w_array(out, block.reshape(-1), flags)
