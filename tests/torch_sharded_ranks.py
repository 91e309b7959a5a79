"""Gloo ranks on the CPU for tests/test_torch_sharding.py.

``spawn_ranks(job, world, out_dir, **kw)`` runs ``job_<job>`` of this
module on ``world`` gloo ranks through chip_smoke.py's ``spawn_ranks``
(the spawn start method, a ``file://`` rendezvous in ``out_dir``, so
xdist workers never share a TCP port), each rank with one intra-op
thread, and returns each rank's dict of arrays.  This module imports
neither JAX nor the JAX package, so the ranks start quickly.
"""
from __future__ import annotations

import os

import numpy as np


def spawn_ranks(job: str, world: int, out_dir: str, **kw) -> list:
    import chip_smoke

    return chip_smoke.spawn_ranks(f"torch_sharded_ranks:job_{job}", world, out_dir,
                                  backend="gloo", device="cpu", threads=1, **kw)


def _cornell():
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import cornell_box

    return build_scene(cornell_box(), device="cpu")


def job_cornell(out_dir, device, width=16, height=16, spp=4, max_depth=4, guided_spp=8,
                fit_every=4):
    """On a world of 3: the unguided render at world sizes 1, 2 and 3 (the
    subgroups of ranks [0] and [0, 1], and the world); at world size 2
    the merged statistics of a guided wave beside one rank's statistics
    of the whole wave, a guided render twice (from a 4^3 grid of 4 lobes)
    with the collectives it made, and the checkpoint-resume twin."""
    import torch
    import torch.distributed as dist

    import chip_smoke
    from mitsuba_path_guiding_torch.guiding.fit import (
        accumulate_stats,
        fit_from_records,
        update_grid,
    )
    from mitsuba_path_guiding_torch.guiding.grid import make_grid
    from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
    from mitsuba_path_guiding_torch.integrators.path import BRUTE_FORCE_MAX_TRIS
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.parallel import mesh as pm

    scene = _cornell()
    rank = dist.get_rank()
    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]), 3: None}
    cfg = RenderConfig(width=width, height=height, spp=spp, max_depth=max_depth, seed=0)
    out = {}
    for ws, group in groups.items():
        if rank >= ws:
            continue
        m = pm.make_device_mesh("cpu", group=group)
        assert (m.rank, m.world_size) == (rank, ws)
        pm.reset_collectives()
        img, _, seg = pm.render_sharded(scene, cfg, m)
        out[f"img_ws{ws}"] = img.numpy()
        out[f"seg_ws{ws}"] = np.int64(seg)
        out[f"collectives_ws{ws}"] = np.asarray([pm.COLLECTIVES[k] for k in (
            "merge_film", "merge_stats", "all_gather")])
    if rank >= 2:
        return out
    m2 = pm.make_device_mesh("cpu", group=groups[2])
    guide = make_guide_fn(0.5, mat_types=types_present(scene.mats))

    # the statistics of one guided wave: merged over the two ranks, and of
    # the whole wave on one rank (the same lanes, the same records)
    grid = make_grid(scene.aabb_min, scene.aabb_max, res=4, n_lobes=4, device="cpu")
    n_pix = width * height
    pix = torch.arange(n_pix)
    sidx = torch.zeros_like(pix)
    step = pm.make_sharded_step(scene, cfg, m2, guide=guide)
    _, stats, _ = step(pix, sidx, pm.init_sharded_film(cfg, m2), grid)
    merged = pm.merge_stats(stats, m2)
    use_bvh = int(scene.geo.p0.shape[0]) > BRUTE_FORCE_MAX_TRIS
    _, _, _, rec = pm._wave_local(scene, cfg, use_bvh, guide, grid, pix, sidx, record=True)
    whole = accumulate_stats(grid, rec)
    for i, (a, b) in enumerate(zip(merged, whole)):
        out[f"stats_merged{i}"] = a.numpy()
        out[f"stats_whole{i}"] = b.numpy()
    # fit_from_records over this rank's records with the mesh: the update
    # of the merged sums
    per = n_pix // 2
    mine = slice(rank * per, (rank + 1) * per)
    _, _, _, rec_mine = pm._wave_local(scene, cfg, use_bvh, guide, grid, pix[mine], sidx[mine],
                                       record=True)
    out.update(chip_smoke._grid_rec("fit_mesh_", fit_from_records(grid, rec_mine, m2)))
    out.update(chip_smoke._grid_rec("fit_merged_", update_grid(grid, *merged)))

    gcfg = cfg._replace(spp=guided_spp)
    for run in range(2):
        pm.reset_collectives()
        img, g, seg = pm.render_sharded(scene, gcfg, m2, guide=guide, grid=grid,
                                        fit_every=fit_every)
        out[f"guided_img{run}"] = img.numpy()
        out[f"guided_seg{run}"] = np.int64(seg)
        out.update(chip_smoke._grid_rec(f"guided_grid{run}_", g))
        out[f"guided_collectives{run}"] = np.asarray([pm.COLLECTIVES[k] for k in (
            "merge_film", "merge_stats", "all_gather", "bytes")])

    out.update(_checkpoint_resume(scene, m2, guide, out_dir, width, height))
    return out


def _checkpoint_resume(scene, m, guide, out_dir, width, height):
    """tests/test_sharding.py's checkpoint-resume recipe on mesh ``m``: 4
    spp guided straight, and 2 spp, a checkpoint through utils/checkpoint
    (rank 0 writes it), a fresh load and 2 more spp from sample 2."""
    import torch
    import torch.distributed as dist

    from mitsuba_path_guiding_torch.film.film import Film, develop, new_film
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig
    from mitsuba_path_guiding_torch.parallel import mesh as pm
    from mitsuba_path_guiding_torch.utils.checkpoint import (
        load_renderer_state,
        save_renderer_state,
    )

    cfg4 = RenderConfig(width=width, height=height, spp=4, max_depth=3, seed=0)
    cfg2 = cfg4._replace(spp=2)
    img4, _, _ = pm.render_sharded(scene, cfg4, m, guide=guide, fit_every=2)

    class _Shim:
        device = m.device

    n_pix = width * height
    img_a, grid_a, _ = pm.render_sharded(scene, cfg2, m, guide=guide, fit_every=2)
    path = os.path.join(out_dir, "ckpt.npz")
    if m.rank == 0:
        r = _Shim()
        r.film = Film(rgb_weight=torch.cat([img_a.reshape(n_pix, 3) * 2.0,
                                            torch.full((n_pix, 1), 2.0)], dim=1),
                      width=width, height=height)
        r.sample_counter, r.progression, r.grid = 2, 1, grid_a
        save_renderer_state(r, path)
    dist.barrier(group=m.group)
    r2 = _Shim()
    r2.film = new_film(width, height)
    r2.sample_counter, r2.progression, r2.grid = 0, 0, grid_a
    load_renderer_state(r2, path)
    assert r2.sample_counter == 2 and r2.progression == 1
    img_b, _, _ = pm.render_sharded(scene, cfg2, m, guide=guide, fit_every=2, grid=r2.grid,
                                    sample_offset=2)
    rgbw_b = torch.cat([img_b.reshape(n_pix, 3) * 2.0, torch.full((n_pix, 1), 2.0)], dim=1)
    combined = develop(Film(rgb_weight=r2.film.rgb_weight + rgbw_b, width=width, height=height))
    return {"ckpt_straight": img4.numpy(), "ckpt_combined": combined.numpy()}
