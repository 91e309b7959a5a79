"""Converters from the reference's arrays to the port's containers.

The JAX package's ``SceneData`` and ``GuidingGrid`` reach this module as
plain dictionaries of numpy arrays (nested containers as nested
dictionaries, ``None`` fields kept), so the same compiled scene and the
same trained grid can be fed to both packages; a scene's nested material
rows (BLEND, MASK, COATING), its coat transmittance table, its sun and
sky emitter rows and environment tables, its sensor (the host-side
``kind``, ``kc`` and ``meas_scale``) and its medium (every ``MediumData``
field: the host-side ``enabled``, ``heterogeneous`` and ``phase_kind``,
the fiber and mixture phases' tables) come across as they are.
The BVH (given the port's packed layout), blocklist and pair tables come
across too, and a two-level ``BlockTable`` (``ops/intersect_twolevel.py``)
through ``block_table_from_numpy``; the chain integrators' state through
``mlt_state_from_numpy`` and ``tensors_from_numpy``; an irradiance
cache and a set of subsurface samples through
``irradiance_cache_from_numpy`` and ``ss_samples_from_numpy``; a
hand-built ``Geometry`` (a triangle soup with no scene around it, as the
manifold walks take) through ``geometry_from_numpy``.
"""
from __future__ import annotations

import numpy as np
import torch

from mitsuba_path_guiding_torch.accel.bvh import pack_bvh
from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.guiding.grid import GuidingGrid
from mitsuba_path_guiding_torch.ops.intersect_twolevel import BlockTable
from mitsuba_path_guiding_torch.scene.types import (
    BVH,
    BlockList,
    Emitters,
    Geometry,
    Materials,
    MediumData,
    PairTable,
    SceneData,
    Sensor,
)

_INT_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16, np.uint32)


def _tensor(x, dev):
    if x is None:
        return None
    a = np.asarray(x)
    if a.dtype == np.bool_:
        return torch.as_tensor(a.copy(), device=dev)
    if a.dtype.type in _INT_DTYPES:
        return torch.as_tensor(a.astype(np.int32), device=dev)
    return torch.as_tensor(a.astype(np.float32), device=dev)


def _fill(cls, d: dict, dev, host: tuple = ()):
    kw = {}
    for name in cls._fields:
        if name not in d:
            continue
        v = d[name]
        if name in host:
            kw[name] = v if isinstance(v, bool) else int(np.asarray(v))
        else:
            kw[name] = _tensor(v, dev)
    return cls(**kw)


def _tables(cls, d, dev, host=()):
    # tblT arrives as bfloat16 (ml_dtypes), which float32 holds exactly
    return None if d is None else _fill(cls, d, dev, host=host)


def scene_from_numpy(d: dict, device=None) -> SceneData:
    """SceneData on ``device`` from the reference scene's numpy arrays."""
    dev = resolve_device(device)
    med = d.get("medium")
    medium = None
    if med is not None:
        medium = _fill(MediumData, {k: med[k] for k in MediumData._fields if k in med}, dev,
                       host=("enabled", "heterogeneous", "phase_kind"))
    geo = _fill(Geometry, d["geo"], dev)
    bvh = _tables(BVH, d.get("bvh"), dev, host=("max_depth",))
    return SceneData(
        geo=geo,
        bvh=None if bvh is None else pack_bvh(bvh, geo.p0, geo.e1, geo.e2),
        mats=_fill(Materials, d["mats"], dev),
        emitters=_fill(Emitters, d["emitters"], dev),
        sensor=_fill(Sensor, d["sensor"], dev, host=("kind",)),
        medium=medium,
        aabb_min=_tensor(d["aabb_min"], dev),
        aabb_max=_tensor(d["aabb_max"], dev),
        textures=_tensor(d["textures"], dev),
        texture_sizes=_tensor(d["texture_sizes"], dev),
        sss_packed=_tensor(d.get("sss_packed"), dev),
        blocks=_tables(BlockList, d.get("blocks"), dev, host=("n_blocks",)),
        pairs=_tables(PairTable, d.get("pairs"), dev),
    )


def geometry_from_numpy(d: dict, device=None) -> Geometry:
    """Geometry on ``device`` from the reference's numpy arrays."""
    return _fill(Geometry, d, resolve_device(device))


def block_table_from_numpy(d: dict, device=None):
    """Two-level BlockTable on ``device`` from the reference's numpy
    arrays."""
    return _fill(BlockTable, d, resolve_device(device))


def grid_from_numpy(d: dict, device=None) -> GuidingGrid:
    """GuidingGrid on ``device`` from the reference grid's numpy arrays."""
    return _fill(GuidingGrid, d, resolve_device(device), host=("res0", "n_used"))


def mlt_state_from_numpy(d: dict, device=None):
    """``integrators.mlt.MLTState`` on ``device`` from the reference's
    chain state as numpy arrays (a dict of its fields)."""
    from mitsuba_path_guiding_torch.integrators.mlt import MLTState

    return _fill(MLTState, d, resolve_device(device))


def tensors_from_numpy(arrays, device=None):
    """A tuple of tensors on ``device`` from numpy arrays, float32, int32
    and bool kept apart: the PSSMLT chain (u (D, N), I (N,), C (N, 3), xy
    (N, 2)), SPPM's hitpoint and photon arrays."""
    dev = resolve_device(device)
    return tuple(_tensor(x, dev) for x in arrays)


def irradiance_cache_from_numpy(d: dict, device=None):
    """``integrators.irrcache.IrradianceCache`` on ``device`` from the
    reference's cache as numpy arrays (a dict of its fields)."""
    from mitsuba_path_guiding_torch.integrators.irrcache import IrradianceCache

    return _fill(IrradianceCache, d, resolve_device(device))


def ss_samples_from_numpy(d: dict, device=None):
    """``integrators.subsurface.SSSamples`` on ``device`` from the
    reference's irradiance samples as numpy arrays (a dict of its
    fields)."""
    from mitsuba_path_guiding_torch.integrators.subsurface import SSSamples

    return _fill(SSSamples, d, resolve_device(device))
