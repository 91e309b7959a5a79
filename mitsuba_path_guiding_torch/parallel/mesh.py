"""Multi-GPU rendering: pixel-sharded waves, one process per card on
``torch.distributed`` (port of the reference's parallel/mesh.py).

Each process drives one card; the host work of a wave (its eager launches)
runs in every process at once.  Rank k of W takes the k-th contiguous
block of a wave's pixel array, the block the reference's ``P(AXIS)`` gives
device k, and renders it with keys made from the global pixel id, so the
placement never enters the random numbers.  Every rank keeps a full-size
partial film and its own guiding statistics; nothing is exchanged during
a wave.  The only collectives are the merges, ``merge_stats`` once per
progression (every ``fit_every`` waves) and ``merge_film`` once at the
end: each is one all-gather of the rank's tensors, as bytes, and a sum in
rank order.  That order, not the backend's reduction order, fixes the
result, so it is the same under gloo and NCCL and at every world size
(an unguided box-filtered image is bit-equal at every world size that
divides its pixel count: every pixel takes its samples on one rank and
+0 from the others).  Every rank updates the grid from the same sums, so
the grids are equal on every rank.  Gloo gathers host tensors only: under
gloo the card's tensors go through host memory for the gather.

``make_device_mesh`` reads the initialized default process group (or the
``group`` given); with none it is world size 1.  Start one process per
card, e.g. ``torchrun --nproc_per_node=N script.py``, and call
``torch.distributed.init_process_group("nccl")`` before making the mesh.

``COLLECTIVES`` counts the merges and, when the world size is above 1,
the all-gathers and the bytes each rank receives.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.film.film import Film, develop, splat
from mitsuba_path_guiding_torch.guiding.fit import accumulate_stats, update_grid
from mitsuba_path_guiding_torch.integrators.path import resolve_use_bvh, trace
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, wave_keys_and_jitter
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene.types import SceneData

AXIS = "dev"

COLLECTIVES = {"merge_film": 0, "merge_stats": 0, "all_gather": 0, "bytes": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


class DeviceMesh(NamedTuple):
    """This process's place in a 1-D mesh of ranks, one card each."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None  # the process group; None at world size 1 without one


def make_device_mesh(device=None, group=None) -> DeviceMesh:
    """The mesh of ``group``, else of the initialized default group, else
    world size 1.  ``device`` None is ``cuda:LOCAL_RANK``."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    rank, world = 0, 1
    if group is not None:
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        if rank < 0:
            raise ValueError("this process is not a member of the mesh's group")
    if device is None:
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return DeviceMesh(rank, world, resolve_device(device), group)


def _wave_local(scene, cfg: RenderConfig, use_bvh, guide, grid, pixel_id, sample_idx,
                em_kinds=em_mod.PORTED_KINDS, mat_types=None, record=None, sensor_kind=0,
                vol=False, guide_distance=False):
    """One rank's wave over its pixel shard: (film_xy, L, aux, records).
    ``vol=True`` takes the volumetric tracer (guided distance and phase
    sampling).  As in the reference, the camera is perspective
    (``sensor_kind`` 0) and the wave applies no textures."""
    from mitsuba_path_guiding_torch.integrators.volpath import trace_vol

    if mat_types is None:
        mat_types = bsdf_mod.PORTED_TYPES
    _, rkeys, u_cam, u_pos = wave_keys_and_jitter(cfg, pixel_id, sample_idx)
    o, d, film_xy = generate_rays(scene.sensor, cfg.width, cfg.height, pixel_id, u_pos,
                                  u_cam[..., 2:4], kind=sensor_kind)
    record = (guide is not None) if record is None else record
    kw = dict(max_depth=cfg.max_depth, rr_depth=cfg.rr_depth, use_nee=cfg.use_nee,
              use_bvh=use_bvh, guide=guide, guide_state=grid, record_paths=record,
              em_kinds=em_kinds, mat_types=mat_types, accel=cfg.accel)
    if vol:
        L, aux, rec = trace_vol(scene, o, d, rkeys, hetero=bool(scene.medium.heterogeneous),
                                phase_kind=int(scene.medium.phase_kind),
                                guide_distance=guide_distance, **kw)
    else:
        L, aux, rec = trace(scene, o, d, rkeys, **kw)
    if cfg.max_component_value > 0.0:
        L = torch.clamp_max(L, cfg.max_component_value)
    return film_xy, L, aux, rec


def make_sharded_step(scene: SceneData, cfg: RenderConfig, mesh: DeviceMesh, guide=None,
                      train: bool = True, vol: bool = False, guide_distance: bool = False):
    """The sharded render (and guiding-train) step of this rank.

    Returns step(pixel_ids (N,), sample_idx (N,), rgbw (1, H*W, 4), grid)
    -> (rgbw', stats | None, n_seg (1,)): ``pixel_ids`` and ``sample_idx``
    are the whole wave's, of which this rank renders its block (N must
    divide by the world size); ``rgbw`` is this rank's partial film and
    ``stats`` its statistics of the wave, each with a leading axis of 1
    (the rank's slice of the reference's (n_dev, ...) arrays); ``n_seg``
    its path segments.  No collective runs in a step.  With
    ``train=False`` the guide still samples but no records or statistics
    are made.  ``cfg.use_bvh`` (None: above BRUTE_FORCE_MAX_TRIS
    triangles) sends the waves through the BVH unless ``cfg.accel`` or
    block tables route them otherwise (``integrators.path.trace``)."""
    use_bvh = resolve_use_bvh(scene, cfg)
    em_kinds = em_mod.kinds_present(scene.emitters)
    mat_types = bsdf_mod.types_present(scene.mats)
    record = train and guide is not None

    def step(pixel_id, sample_idx, rgbw, grid):
        n = pixel_id.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"{n} lanes do not divide over {mesh.world_size} ranks")
        per = n // mesh.world_size
        mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
        film_xy, L, aux, rec = _wave_local(
            scene, cfg, use_bvh, guide, grid, pixel_id[mine], sample_idx[mine], em_kinds,
            mat_types, record, vol=vol, guide_distance=guide_distance)
        rgbw_out = splat(rgbw[0], film_xy, L, cfg.width, cfg.height, cfg.filter_name)[None]
        stats = tuple(x[None] for x in accumulate_stats(grid, rec)) if record else None
        return rgbw_out, stats, torch.sum(aux.n_bounces)[None]

    return step


def init_sharded_film(cfg: RenderConfig, mesh: DeviceMesh):
    """This rank's (1, H*W, 4) zero partial film."""
    return torch.zeros((1, cfg.width * cfg.height, 4), dtype=torch.float32, device=mesh.device)


def _sum_over_ranks(tensors, mesh, merge: str):
    """Each of ``tensors`` summed over the mesh's ranks in rank order,
    from one all-gather of their bytes."""
    COLLECTIVES[merge] += 1
    if mesh is None:
        mesh = make_device_mesh(device=tensors[0].device)
    if mesh.world_size == 1:
        return list(tensors)
    flat = [x.contiguous().reshape(-1).view(torch.uint8) for x in tensors]
    buf = torch.cat(flat)
    if buf.is_cuda and dist.get_backend(mesh.group) == "gloo":
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(mesh.world_size)]
    dist.all_gather(parts, buf, group=mesh.group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["bytes"] += buf.numel() * mesh.world_size
    out = []
    off = 0
    for x, f in zip(tensors, flat):
        nb = f.numel()
        total = None
        for part in parts:
            v = part[off:off + nb].to(x.device).clone().view(x.dtype).reshape(x.shape)
            total = v if total is None else total + v
        out.append(total)
        off += nb
    return out


def merge_film(rgbw_sharded, mesh: DeviceMesh | None = None):
    """The ranks' partial films (1, H*W, 4) summed in rank order ->
    (H*W, 4): one collective, once per render."""
    return _sum_over_ranks([rgbw_sharded[0]], mesh, "merge_film")[0]


def merge_stats(stats_sharded, mesh: DeviceMesh | None = None):
    """The ranks' guiding statistics (each with a leading axis of 1)
    summed in rank order: one collective, once per progression."""
    return tuple(_sum_over_ranks([x[0] for x in stats_sharded], mesh, "merge_stats"))


def render_sharded(scene: SceneData, cfg: RenderConfig, mesh: DeviceMesh | None = None,
                   guide=None, grid=None, fit_every: int = 4, progress=None,
                   sample_offset: int = 0):
    """Full sharded render; returns ((H, W, 3) image, grid, total path
    segments), the same on every rank.

    With guiding, each rank sums its statistics over ``fit_every`` waves;
    one merge and the EM update follow on every rank, and the film is
    merged once at the end, together with the segment count, which stays
    on the card until then.  Pass the returned grid back in, with
    ``sample_offset``, to continue training across calls.  Where the
    world size does not divide the pixel count, the wave is padded with
    pixel 0 at the same sample index (the reference's padding), so
    pixel 0 takes a few duplicate samples."""
    mesh = mesh if mesh is not None else make_device_mesh()
    step = make_sharded_step(scene, cfg, mesh, guide=guide)

    n_pix = cfg.width * cfg.height
    pad = (-n_pix) % mesh.world_size
    dev = mesh.device
    all_pixels = torch.cat([torch.arange(n_pix, dtype=torch.int64, device=dev),
                            torch.zeros((pad,), dtype=torch.int64, device=dev)])
    rgbw = init_sharded_film(cfg, mesh)
    if guide is not None and grid is None:
        from mitsuba_path_guiding_torch.guiding.grid import make_grid

        grid = make_grid(scene.aabb_min, scene.aabb_max, device=dev)
    seg = torch.zeros((1,), dtype=torch.int64, device=dev)
    acc = None
    for s in range(cfg.spp):
        sidx = torch.full_like(all_pixels, sample_offset + s)
        rgbw, stats, n_seg = step(all_pixels, sidx, rgbw, grid)
        seg = seg + n_seg
        if stats is not None:
            acc = stats if acc is None else tuple(a + b for a, b in zip(acc, stats))
            if (s + 1) % max(fit_every, 1) == 0 or s + 1 == cfg.spp:
                grid = update_grid(grid, *merge_stats(acc, mesh))
                acc = None
        if progress is not None:
            progress(s, cfg.spp)
    film, seg = _sum_over_ranks([rgbw[0], seg], mesh, "merge_film")
    img = develop(Film(rgb_weight=film, width=cfg.width, height=cfg.height))
    return img, grid, int(seg[0])
