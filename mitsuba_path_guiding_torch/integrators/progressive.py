"""Progressive (guided) rendering: full-image passes with guiding-cache
updates between progressions (port of the reference's
integrators/progressive.py ``ProgressiveConfig`` and
``ProgressiveRenderer``, with sample and time budgets).

Each progression renders ``samples_per_progression`` spp as waves of the
wavefront tracer with path records, sums the fitting statistics of its
waves and makes one EM update of the vMF grid, then, with
``adaptive_refine``, splits the cells that gathered more than
``refine_threshold`` samples.  Per-pixel sample counters persist across
progressions, so the random sequences continue, with every sampler of
``RenderConfig.sampler``; the film takes ``RenderConfig.filter_name``.
A scene with a medium, or any scene with ``RenderConfig.integrator`` =
"volpath", runs the volumetric tracer (with guided distance sampling when
``guide_distance``); ``RenderConfig.use_bvh`` reaches the tracers'
routes, and ``RenderConfig.max_component_value`` clamps each sample's
radiance.  ``train_progressions`` > 0 stops the fit
after that many progressions; ``on_preprogression`` and
``on_postprogression`` are called with the renderer around each
progression; ``queue`` (a ``utils.logger.RenderQueue``) receives the
render's events, and its listeners may pause or stop the loop between
progressions.  The developed image is read back to the host for the
queue only when a listener is registered.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from mitsuba_path_guiding_torch.film.film import Film, develop, new_film, splat
from mitsuba_path_guiding_torch.guiding.fit import (
    SPLIT_THRESHOLD,
    accumulate_stats,
    refine_grid,
    update_grid,
)
from mitsuba_path_guiding_torch.guiding.grid import GuidingGrid, make_grid
from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
from mitsuba_path_guiding_torch.integrators.path import resolve_use_bvh, trace
from mitsuba_path_guiding_torch.integrators.render import (
    RenderConfig,
    texture_flags,
    wave_keys_and_jitter,
)
from mitsuba_path_guiding_torch.integrators.volpath import trace_vol
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene.types import SceneData
from mitsuba_path_guiding_torch.utils.logger import RenderQueue
from mitsuba_path_guiding_torch.utils.stats import host_read, span


@dataclass
class ProgressiveConfig:
    render: RenderConfig = field(default_factory=RenderConfig)
    samples_per_progression: int = 4
    n_progressions: int = 8           # total spp = spp_per_prog * n_prog
    max_seconds: float = 0.0          # > 0: time-budget mode
    guiding: bool = True
    guide_alpha: float = 0.5          # share of directions drawn from the mixture
    parallax: bool = True             # parallax-aware lobe reprojection
    # guided distance sampling in media: radiance-weighted collision
    # distances, one-sample MIS'd with the analytic sampler
    guide_distance: bool = True
    grid_res: int = 16
    n_lobes: int = 8
    # adaptive spatial refinement between progressions; capacity_factor
    # reserves rows for the children
    adaptive_refine: bool = False
    refine_threshold: float = SPLIT_THRESHOLD
    capacity_factor: int = 4
    train_progressions: int = 0       # 0 = train on all progressions
    on_preprogression: Optional[Callable] = None
    on_postprogression: Optional[Callable] = None
    # render events and controls; None = progress through the default logger
    queue: Optional[RenderQueue] = None


class ProgressiveRenderer:
    """Host-side loop, device-side compute."""

    def __init__(self, scene: SceneData, cfg: ProgressiveConfig):
        from mitsuba_path_guiding_torch.models.bsdf import types_present
        from mitsuba_path_guiding_torch.models.emitter import kinds_present
        from mitsuba_path_guiding_torch.utils.stats import StatsRegistry

        self.scene = scene
        self.cfg = cfg
        self.device = scene.geo.p0.device
        r = cfg.render
        self.film = new_film(r.width, r.height, device=self.device)
        self.sample_counter = 0
        self.progression = 0
        self.grid: Optional[GuidingGrid] = None
        if cfg.guiding:
            self.grid = make_grid(
                scene.aabb_min, scene.aabb_max, res=cfg.grid_res, n_lobes=cfg.n_lobes,
                capacity=(cfg.capacity_factor if cfg.adaptive_refine else 1) * cfg.grid_res**3)
        self.use_bvh = resolve_use_bvh(scene, r)
        self.em_kinds = kinds_present(scene.emitters)
        self.mat_types = types_present(scene.mats)
        self.tex_flags = texture_flags(scene)
        self.guide_fn = (make_guide_fn(cfg.guide_alpha, mat_types=self.mat_types,
                                       parallax=cfg.parallax) if cfg.guiding else None)
        self.stats = StatsRegistry()

    def _wave(self, pixel_id, sample_idx, train: bool = True):
        """One wave: (film_xy, L, aux, records), the records (for the
        grid's fit) only when ``train`` and guiding is on.  Textures,
        bump maps and cloth are on as the scene needs them; no mip
        filtering (no cone angle), as in the reference's progressive
        renderer."""
        r = self.cfg.render
        _, rkeys, u_cam, u_pos = wave_keys_and_jitter(r, pixel_id, sample_idx)
        o, d, film_xy = generate_rays(self.scene.sensor, r.width, r.height, pixel_id, u_pos,
                                      u_cam[..., 2:4], kind=self.scene.sensor.kind)
        kw = dict(max_depth=r.max_depth, rr_depth=r.rr_depth, use_nee=r.use_nee,
                  use_bvh=self.use_bvh, accel=r.accel, guide=self.guide_fn, guide_state=self.grid,
                  record_paths=train and self.grid is not None, em_kinds=self.em_kinds,
                  mat_types=self.mat_types)
        if self.scene.medium.enabled or r.integrator == "volpath":
            med = self.scene.medium
            L, aux, rec = trace_vol(
                self.scene, o, d, rkeys, hetero=med.heterogeneous, phase_kind=med.phase_kind,
                guide_distance=self.cfg.guide_distance and self.guide_fn is not None, **kw)
        else:
            L, aux, rec = trace(self.scene, o, d, rkeys, **kw, **self.tex_flags)
        if r.max_component_value > 0.0:
            L = torch.clamp_max(L, r.max_component_value)
        return film_xy, L, aux, rec

    def run_progression(self):
        """One full-image pass of samples_per_progression spp."""
        cfg, r = self.cfg, self.cfg.render
        if cfg.on_preprogression is not None:
            cfg.on_preprogression(self)
        with span("progression", device=self.device):
            self._progression()
        self.progression += 1
        if cfg.on_postprogression is not None:
            cfg.on_postprogression(self)

    def _progression(self):
        cfg, r = self.cfg, self.cfg.render
        training = cfg.guiding and (
            cfg.train_progressions <= 0 or self.progression < cfg.train_progressions)
        n_pix = r.width * r.height
        all_pixels = torch.arange(n_pix, dtype=torch.int64, device=self.device)
        rgbw = self.film.rgb_weight
        records = []
        seg_total = torch.zeros((), dtype=torch.int64, device=self.device)
        lane_total = 0
        for batch_start in range(0, n_pix, r.pixel_batch):
            pix = all_pixels[batch_start: batch_start + r.pixel_batch]
            for s in range(cfg.samples_per_progression):
                sidx = torch.full_like(pix, self.sample_counter + s)
                with span("wave"):
                    film_xy, L, aux, rec = self._wave(pix, sidx, training)
                    with span("splat"):
                        rgbw = splat(rgbw, film_xy, L, r.width, r.height, r.filter_name)
                seg_total += torch.sum(aux.n_bounces)
                lane_total += int(pix.shape[0])
                if rec is not None:
                    records.append(rec)
        # the segment count stays on the device until the report reads it
        self.stats.add("samples", lane_total)
        rays = seg_total * 2 if r.use_nee else seg_total  # path and shadow rays
        self.stats.add("rays traced", rays)
        self.stats.average("avg path length", seg_total, max(lane_total, 1))
        self.film = Film(rgb_weight=rgbw, width=r.width, height=r.height)
        self.sample_counter += cfg.samples_per_progression

        if records:
            with span("fit"):
                acc = None
                for rec in records:
                    st = accumulate_stats(self.grid, rec)
                    acc = st if acc is None else tuple(a + b for a, b in zip(acc, st))
                self.grid = update_grid(self.grid, *acc)
                if cfg.adaptive_refine:
                    self.grid = refine_grid(self.grid, cfg.refine_threshold)

    def render(self) -> torch.Tensor:
        """Sample-budget (or time-budget) progressive render; a listener's
        stop ends it early with the samples rendered so far."""
        cfg = self.cfg
        queue = RenderQueue() if cfg.queue is None else cfg.queue
        t0 = time.time()
        queue.begin(cfg.n_progressions)
        for i in range(cfg.n_progressions):
            ctrl = queue.poll_controls()
            while ctrl["pause"] and not ctrl["stop"]:
                time.sleep(0.2)
                ctrl = queue.poll_controls()
            if ctrl["stop"]:
                break
            self.run_progression()
            queue.progression(i, cfg.n_progressions, self.sample_counter,
                              image=self.image() if queue.listeners else None)
            if cfg.max_seconds > 0 and time.time() - t0 > cfg.max_seconds:
                break
        queue.finish(self.sample_counter, image=self.image() if queue.listeners else None)
        return develop(self.film)

    def image(self) -> np.ndarray:
        """The developed image so far, on the host."""
        return host_read(develop(self.film), "progressive.image").numpy()


def render_progressive(scene: SceneData, cfg: ProgressiveConfig) -> torch.Tensor:
    return ProgressiveRenderer(scene, cfg).render()
