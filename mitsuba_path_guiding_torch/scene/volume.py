"""Volume data sources: VOL and npy grids, hierarchical grids (host-side
numpy; a copy of the reference's numpy-only scene/volume.py).

The result is a dense (D, H, W) float32 density grid and an optional
world AABB, which the scene compiler turns into
``MediumData.world_to_grid``.  OpenVDB files raise until the VDB codec is
ported (ROADMAP Queue 1 item 9, "the loaders").
"""
from __future__ import annotations

import struct

import numpy as np


def load_vol(path: str):
    """Read Mitsuba's binary VOL grid format (gridvolume.cpp:
    'VOL' magic, uint8 version=3, int32 encoding (1 = float32),
    int32 xres/yres/zres, int32 channels, 6x float32 world AABB,
    then xres*yres*zres*channels float32 with x varying fastest).

    Returns (data (D=zres, H=yres, W=xres) float32 — channel-averaged if
    multi-channel, aabb (2, 3) float32 world bounds).
    """
    with open(path, "rb") as f:
        magic = f.read(3)
        if magic != b"VOL":
            raise ValueError(f"{path}: not a VOL file (magic {magic!r})")
        (version,) = struct.unpack("B", f.read(1))
        if version != 3:
            raise ValueError(f"{path}: unsupported VOL version {version}")
        enc, xres, yres, zres, channels = struct.unpack("<5i", f.read(20))
        if enc != 1:
            raise ValueError(f"{path}: only float32 VOL encoding supported (got {enc})")
        aabb = np.array(struct.unpack("<6f", f.read(24)), dtype=np.float32)
        n = xres * yres * zres * channels
        data = np.frombuffer(f.read(4 * n), dtype="<f4", count=n)
    data = data.reshape(zres, yres, xres, channels)
    if channels > 1:
        data = data.mean(axis=-1)
    else:
        data = data[..., 0]
    return np.ascontiguousarray(data, dtype=np.float32), aabb.reshape(2, 3)


def save_vol(path: str, data: np.ndarray, aabb_min, aabb_max):
    """Write a single-channel float32 VOL grid (for tests / converters)."""
    data = np.asarray(data, dtype=np.float32)
    zres, yres, xres = data.shape
    with open(path, "wb") as f:
        f.write(b"VOL")
        f.write(struct.pack("B", 3))
        f.write(struct.pack("<5i", 1, xres, yres, zres, 1))
        f.write(struct.pack("<6f", *np.asarray(aabb_min, dtype=np.float32),
                            *np.asarray(aabb_max, dtype=np.float32)))
        f.write(data.astype("<f4").tobytes())


def vdb_to_dense(path: str, grid_name: str = "density"):
    """An OpenVDB grid as a dense array: not ported yet (the VDB codec,
    ``scene/vdb.py``, comes with ROADMAP Queue 1 item 9, "the loaders")."""
    raise NotImplementedError(
        f"{path}: OpenVDB volumes: ROADMAP Queue 1 item 9 (the loaders)")


# Grids stay in device memory for the whole render (there is no
# out-of-core path); the loader warns above this size so that an
# out-of-memory failure is attributable.
_HBM_GRID_WARN_BYTES = 4 << 30


def load_volume_spec(spec) -> tuple[np.ndarray, np.ndarray | None]:
    """Resolve a scene-dict volume spec to (grid (D,H,W), aabb (2,3)|None).

    Accepted forms (mirroring the reference plugin names):
      {"type": "constvolume", "value": v}                  -> (1,1,1) grid
      {"type": "gridvolume", "filename": x.vol|x.npy}      -> file grid
      {"type": "gridvolume", "data": ndarray, "bounds": ((lo),(hi))}
      {"type": "vdbvolume", "filename": x.vdb, "grid": name}
      bare ndarray / nested list                            -> data grid

    Grids stay in device memory (see _HBM_GRID_WARN_BYTES); volumes
    larger than it have no out-of-core path.
    """
    if not isinstance(spec, dict):
        data = np.asarray(spec, dtype=np.float32)
        if data.ndim != 3:
            raise ValueError("volume data must be a 3-D (D,H,W) array")
        _check_grid_budget(data)
        return data, None
    t = spec.get("type", "gridvolume")
    if t == "constvolume":
        v = float(spec.get("value", 1.0))
        return np.full((1, 1, 1), v, dtype=np.float32), None
    if t == "vdbvolume":
        data, aabb = vdb_to_dense(spec["filename"], spec.get("grid", "density"))
        _check_grid_budget(data)
        return data, aabb
    if t == "gridvolume":
        if "filename" in spec:
            fn = spec["filename"]
            if fn.endswith(".npy"):
                data = np.load(fn).astype(np.float32)
                if data.ndim != 3:
                    raise ValueError(f"{fn}: expected 3-D grid")
                aabb = None
            else:
                data, aabb = load_vol(fn)
        else:
            data = np.asarray(spec["data"], dtype=np.float32)
            aabb = None
        if "bounds" in spec:
            aabb = np.asarray(spec["bounds"], dtype=np.float32).reshape(2, 3)
        _check_grid_budget(data)
        return data, aabb
    if t == "hgridvolume":
        data, aabb = assemble_hgrid(spec)
        _check_grid_budget(data)
        return data, aabb
    raise ValueError(f"unknown volume type {t}")


def _check_grid_budget(data: np.ndarray) -> None:
    if data.nbytes > _HBM_GRID_WARN_BYTES:
        import warnings

        warnings.warn(
            f"volume grid is {data.nbytes / 2**30:.1f} GiB; grids stay in "
            "device memory for the whole render (no out-of-core path)",
            ResourceWarning,
            stacklevel=3,
        )


def assemble_hgrid(spec) -> tuple[np.ndarray, np.ndarray | None]:
    """Hierarchical grid volume (a coarse grid of dense sub-blocks for
    sparse media): the blocks are stitched into one dense grid at compile
    time, empty cells zero.

    Spec: {"type": "hgridvolume", "block_res": B,
           "blocks": [{"offset": (bz, by, bx),
                       "data": (B,B,B) array | "filename": .vol/.npy}],
           "bounds": ((lo),(hi)) optional}
    """
    B = int(spec["block_res"])
    blocks = spec["blocks"]
    if not blocks:
        raise ValueError("hgridvolume: no blocks")
    offs = np.asarray([b["offset"] for b in blocks], dtype=np.int64)
    dims = (offs.max(axis=0) + 1) * B
    grid = np.zeros(tuple(dims), dtype=np.float32)
    for b in blocks:
        if "data" in b:
            d = np.asarray(b["data"], dtype=np.float32)
        else:
            fn = b["filename"]
            d = (np.load(fn).astype(np.float32) if fn.endswith(".npy")
                 else load_vol(fn)[0])
        if d.shape != (B, B, B):
            raise ValueError(f"hgrid block must be ({B},{B},{B}), got {d.shape}")
        z, y, x = (int(v) * B for v in b["offset"])
        grid[z : z + B, y : y + B, x : x + B] = d
    aabb = (
        np.asarray(spec["bounds"], dtype=np.float32).reshape(2, 3)
        if "bounds" in spec else None
    )
    return grid, aabb
