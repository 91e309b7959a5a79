"""Ray-scene intersection front end (port of the reference's
accel/traverse.py).

``intersect_brute`` / ``occluded_brute`` are the dense all-triangle oracle;
``intersect_pallas`` / ``occluded_pallas`` go through the ``intersect_tiled``
kernel's wrapper (the CUDA kernel on the card, its plain version
``tiled_plain``, the same tests, on the CPU).  ``intersect_bvh`` / ``occluded`` walk the scene's BVH
(``ops/intersect_bvh.py``, the ``intersect_bvh`` kernel on the card).
Scenes of 16384 triangles or more carry block tables: with pair tables
they go through ``intersect_pairs_full`` / ``occluded_pairs_full``, the
pair pipeline with the blocklist kernel re-tracing its unproven rays (all
of them, or with ``fb_shift`` the reference's capped share);
without, through ``intersect_twolevel`` / ``occluded_twolevel``, the
blocklist kernel on Morton-sorted rays.  On the card each query launches
its kernels; on the CPU it runs their plain versions.
``shadow_transmittance`` marches shadow rays through NULL and MASK
surfaces with any of these closest-hit queries.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_path_guiding_torch.ops.intersect_blocklist import (
    intersect_blocklist_raw,
    intersect_blocklist_sorted,
    occluded_blocklist_raw,
    occluded_blocklist_sorted,
)
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.ops.intersect_bvh import (  # noqa: F401
    STACK_SIZE,
    bvh_query,
    moeller_trumbore,
)
from mitsuba_path_guiding_torch.ops.intersect_pairs import (
    IMAX,
    PAIR_KSB,
    PAIR_L,
    intersect_pairs_raw,
)
from mitsuba_path_guiding_torch.ops.intersect_tiled import (
    any_plain,
    closest_plain,
    intersect_tiled,
    pack_triangles,
)
from mitsuba_path_guiding_torch.scene.types import BSDFType, BVH, BlockList, Geometry, PairTable
from mitsuba_path_guiding_torch.utils.stats import host_read

INF = 3.0e38
EPS_T = 1e-4  # min ray t (self-intersection offset)


class Hit(NamedTuple):
    t: torch.Tensor      # (N,) hit distance (INF if miss)
    prim: torch.Tensor   # (N,) int32 triangle index (-1 if miss)
    u: torch.Tensor      # (N,) barycentric
    v: torch.Tensor      # (N,)
    valid: torch.Tensor  # (N,) bool


def _full_tmax(o, tmax):
    if tmax is None:
        return torch.full((o.shape[0],), INF, dtype=torch.float32, device=o.device)
    return tmax


def intersect_brute(geo: Geometry, o, d, tmax=None) -> Hit:
    """O(N*T) dense closest hit; ties go to the lowest prim id."""
    return Hit(*closest_plain(geo.p0, geo.e1, geo.e2, o, d, _full_tmax(o, tmax)))


def occluded_brute(geo: Geometry, o, d, tmax) -> torch.Tensor:
    """Any-hit visibility for shadow rays."""
    return any_plain(geo.p0, geo.e1, geo.e2, o, d, tmax)


def tri_pack_rows(geo: Geometry) -> torch.Tensor:
    """(12, Tpad) triangle layout of the tiled intersector."""
    return pack_triangles(geo.p0, geo.e1, geo.e2)


def intersect_pallas(geo: Geometry, o, d, tmax=None, pack=None) -> Hit:
    """Closest hit through the tiled intersector's wrapper.  ``pack``:
    tri_pack_rows(geo), built once per trace by the caller."""
    pack = tri_pack_rows(geo) if pack is None else pack
    return Hit(*intersect_tiled(pack, o, d, _full_tmax(o, tmax), geo.p0.shape[0]))


def occluded_pallas(geo: Geometry, o, d, tmax, pack=None) -> torch.Tensor:
    """Any-hit visibility through the tiled intersector's wrapper."""
    pack = tri_pack_rows(geo) if pack is None else pack
    return intersect_tiled(pack, o, d, tmax, geo.p0.shape[0], any_hit=True)


def _retrace(proven):
    """Indices of the unproven rays, ascending (one host read: the blocklist
    call is sized by their count)."""
    unproven = ~proven
    n = int(host_read(unproven.sum(), "traverse.retrace"))
    return torch.nonzero_static(unproven, size=n).flatten()


def _fallback_cap(n: int, shift: int) -> int:
    """The reference's re-trace budget of a query of n rays."""
    return min(max(4096, n >> shift), n)


def _unproven_idx(proven, cap: int):
    """The reference's selection under its cap: the first ``cap`` unproven
    ray indices, ascending, from one sort of (index, IMAX where proven);
    where fewer rays are unproven the tail repeats index n - 1, which the
    caller masks by ``~proven[idx]``.  A fixed size: no host read."""
    n = proven.shape[0]
    key = torch.where(proven, IMAX, torch.arange(n, dtype=torch.int32, device=proven.device))
    return torch.sort(key).values[:cap].clamp(0, n - 1).long()


def _fallback(proven, fb_shift):
    """The rays to re-trace and the mask of those that take the re-trace:
    every unproven ray (``fb_shift`` None, the port's default), or the
    reference's capped selection (an int)."""
    if fb_shift is None:
        idx = _retrace(proven)
        return idx, None
    idx = _unproven_idx(proven, _fallback_cap(proven.shape[0], fb_shift))
    return idx, ~proven[idx]


def intersect_pairs_full(pairs: PairTable, blocks: BlockList, o, d, tmax=None, ksb=None,
                         l_blk=None, fb_shift=None, cap_factor=None, engine: str = "mt") -> Hit:
    """Closest hit through the pair pipeline (ops/intersect_pairs.py), with
    the blocklist kernel re-tracing, in one launch, the rays whose
    nearest-l_blk list was not proven complete.  ``ksb``, ``l_blk``: the
    list widths (None: the pipeline's PAIR_KSB, PAIR_L).  ``fb_shift``
    None (the default) re-traces every unproven ray.  An int gives the
    reference's cap, at most max(4096, N >> fb_shift) rays, the first
    unproven by index, one launch of that size a query; the rest keep their
    pair result, which can be a farther hit than the true one: on the lower
    half of door_room() at 512x512 (131072 camera rays,
    tools/pair_fallback_shortfall.py) 26262 rays are unproven and 9851 of
    the 18070 beyond the cap at shift 4 keep a wrong hit."""
    tmax = _full_tmax(o, tmax)
    t, prim, u, v, valid, proven = intersect_pairs_raw(
        pairs, o, d, tmax, ksb=ksb or PAIR_KSB, l_blk=l_blk or PAIR_L, cap_factor=cap_factor,
        engine=engine)
    idx, take = _fallback(proven, fb_shift)
    if idx.numel():
        hit = intersect_blocklist_raw(blocks, o[idx], d[idx], tmax[idx])
        for dst, src in zip((t, prim, u, v, valid), hit):
            dst[idx] = src if take is None else torch.where(take, src, dst[idx])
    return Hit(t=t, prim=prim, u=u, v=v, valid=valid)


def occluded_pairs_full(pairs: PairTable, blocks: BlockList, o, d, tmax, ksb=None, l_blk=None,
                        fb_shift=None, cap_factor=None, engine: str = "mt") -> torch.Tensor:
    """Any-hit visibility through the pair pipeline, with the blocklist
    kernel re-tracing the unproven rays (``ksb``, ``l_blk``, ``fb_shift``
    as in ``intersect_pairs_full``)."""
    occ, proven = intersect_pairs_raw(pairs, o, d, tmax, ksb=ksb or PAIR_KSB,
                                      l_blk=l_blk or PAIR_L, any_hit=True,
                                      cap_factor=cap_factor, engine=engine)
    idx, take = _fallback(proven, fb_shift)
    if idx.numel():
        occ2 = occluded_blocklist_raw(blocks, o[idx], d[idx], tmax[idx])
        occ[idx] = occ2 if take is None else torch.where(take, occ2, occ[idx])
    return occ


def intersect_bvh(geo: Geometry, bvh: BVH, o, d, tmax=None, any_hit: bool = False) -> Hit:
    """Closest hit (or, with ``any_hit``, the first hit found) through the
    BVH; ties go to the triangle found first.  ``geo`` is the reference's
    argument: the walk reads the copy of its triangles that ``pack_bvh``
    put in ``bvh``."""
    t, prim, u, v, _ = bvh_query(bvh, o, d, _full_tmax(o, tmax), any_hit)
    valid = prim >= 0
    return Hit(t=torch.where(valid, t, INF), prim=prim, u=u, v=v, valid=valid)


def occluded(geo: Geometry, bvh: BVH, o, d, tmax, use_bvh: bool = True) -> torch.Tensor:
    """Shadow-ray visibility: True if any hit before tmax."""
    if use_bvh:
        return intersect_bvh(geo, bvh, o, d, tmax, any_hit=True).valid
    return occluded_brute(geo, o, d, tmax)


def intersect_twolevel(blocks: BlockList, o, d, tmax=None) -> Hit:
    """Closest hit through the blocklist kernel on Morton-sorted rays: the
    route of a big scene without pair tables."""
    return Hit(*intersect_blocklist_sorted(blocks, o, d, _full_tmax(o, tmax)))


def occluded_twolevel(blocks: BlockList, o, d, tmax) -> torch.Tensor:
    """Any-hit visibility through the blocklist kernel on Morton-sorted
    rays."""
    return occluded_blocklist_sorted(blocks, o, d, tmax)


def shadow_transmittance(geo: Geometry, mats_packed, o, d, tmax, intersect,
                         max_hits: int = 4) -> torch.Tensor:
    """Transmittance of shadow rays through transparent surfaces (the
    surface part of the reference's Scene::evalTransmittance): up to
    ``max_hits`` closest hits, each multiplying the (N,) transmittance by
    its material's straight-through fraction, NULL 1, MASK 1 - opacity,
    any other material 0.  ``intersect(o, d, tmax)`` is the closest-hit
    query of the caller's route (the path tracer passes its wave's own,
    so that the card runs its kernel).  A lane whose transmittance
    reached 0 marches on with a dead tmax (its result cannot change).
    Each step fetches the hit's shading row and material row through
    ``gather_rows_t``."""
    tr = torch.ones((o.shape[0],), dtype=torch.float32, device=o.device)
    o_cur, t_rem = o, tmax
    for _ in range(max_hits):
        h = intersect(o_cur, d, t_rem)
        mid = gather_rows_t(geo.shade_packed, torch.clamp_min(h.prim, 0))[18].to(torch.int32)
        mrow = gather_rows_t(mats_packed, mid)
        mtype = mrow[0].to(torch.int32)
        pass_frac = torch.where(mtype == BSDFType.NULL, 1.0,
                                torch.where(mtype == BSDFType.MASK, 1.0 - mrow[18], 0.0))
        tr = torch.where(h.valid, tr * pass_frac, tr)
        step = torch.where(h.valid, h.t + EPS_T, 0.0)
        o_cur = o_cur + step[..., None] * d
        t_rem = torch.where(tr > 0.0, t_rem - step, -1.0)
    return tr
