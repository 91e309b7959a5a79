"""Render orchestration: camera rays -> trace -> film splat (port of the
reference's integrators/render.py ``RenderConfig``, ``wave_keys_and_jitter``,
``camera_jitter``, ``render_wave`` and ``render``).

On the card, unguided waves with NEE and the independent sampler, without
Sobol' bounce dimensions, of a supported scene (diffuse materials, area
lights, at most 2048 triangles) take the fused megakernel
(``ops.fused_path.trace_fused``), as the reference does on the TPU; every
other wave runs the wavefront ``integrators.path.trace``.

Samplers (``RenderConfig.sampler``) set the camera jitter: ``independent``,
``stratified``, and the low-discrepancy ``halton``, ``hammersley``,
``sobol`` and ``ldsampler`` with a per-pixel rotation or shift;
``qmc_bounces`` > 0 also draws the first bounces' dimensions from
Owen-scrambled Sobol' points (``core.qmc.sobol_path_uniforms``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_path_guiding_torch.core import qmc, rng
from mitsuba_path_guiding_torch.core.rng import TAG_CAMERA
from mitsuba_path_guiding_torch.film.film import Film, develop, new_film, splat
from mitsuba_path_guiding_torch.integrators.path import trace
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene.types import SceneData

# Most pixels in one wave; a larger image renders in several.
PIXEL_BATCH = 1 << 17
# samplers whose jitter is rotated or shifted by per-pixel uniforms
QMC_PIXEL_SAMPLERS = ("sobol", "ldsampler", "halton", "hammersley")
SAMPLERS = ("independent", "stratified") + QMC_PIXEL_SAMPLERS

# fused-kernel table cache keyed by the id of the scene's p0 tensor; the
# stored reference pins that tensor so the id cannot be reused.  None
# entries remember "unsupported".
_FUSED_TABLE_CACHE: dict = {}


def _fused_tables_for(scene):
    """Cached ops.fused_path tables for a supported scene, else None."""
    k = id(scene.geo.p0)
    if k not in _FUSED_TABLE_CACHE:
        from mitsuba_path_guiding_torch.ops.fused_path import build_fused_tables, fused_supported

        tables = build_fused_tables(scene) if fused_supported(scene) else None
        _FUSED_TABLE_CACHE[k] = (scene.geo.p0, tables)
    return _FUSED_TABLE_CACHE[k][1]


class RenderConfig(NamedTuple):
    width: int = 256
    height: int = 256
    spp: int = 16
    max_depth: int = 5
    rr_depth: int = 5
    seed: int = 0
    use_nee: bool = True
    accel: str = "auto"  # integrators.path.trace's route
    sampler: str = "independent"  # camera jitter, one of SAMPLERS
    qmc_bounces: int = 0  # > 0: Sobol' dimensions for the first bounces
    filter_name: str = "box"  # reconstruction filter (film/rfilter.py)


def camera_jitter(cfg, sample_idx, u_cam, u_pix=None):
    """Sub-pixel jitter (N, 2) by sampler: independent, a stratified grid,
    Sobol' (``sobol``, and ``ldsampler``, whose (0, 2)-sequence is the
    first two Sobol' dimensions) digitally shifted per pixel, Halton(2, 3)
    or Hammersley rotated per pixel.  ``u_pix`` (N, 2): uniforms of the
    pixel alone, fixed over its samples; a shift that changed with the
    sample would make the low-discrepancy samplers independent ones."""
    if cfg.sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler '{cfg.sampler}'")
    if u_pix is None:
        u_pix = u_cam[..., 0:2]
    if cfg.sampler in ("sobol", "ldsampler"):
        return qmc.sobol_2d(sample_idx, u_pix)
    if cfg.sampler == "halton":
        return qmc.halton_2d(sample_idx, u_pix)
    if cfg.sampler == "hammersley":
        # (i / N, radical inverse in base 2 of i), rotated per pixel
        pts = torch.stack([sample_idx.to(torch.float32) / float(max(cfg.spp, 1)),
                           qmc.radical_inverse(2, sample_idx)], dim=-1)
        return qmc.cp_rotate(pts, u_pix)
    if cfg.sampler == "stratified":
        return qmc.stratified_2d(sample_idx, max(cfg.spp, 16), u_cam[..., 0:2])
    return u_cam[..., 0:2]


def wave_keys_and_jitter(cfg, pixel_id, sample_idx):
    """Per-ray keys and camera uniforms of a wave.  Returns
    (pkeys, rkeys, u_cam, u_pos), bit-equal to the reference."""
    key = rng.base_key(cfg.seed, device=pixel_id.device)
    pkeys = rng.pixel_keys(key, pixel_id)
    rkeys = rng.fold_in(pkeys, sample_idx)
    u_cam = rng.event_uniform(rkeys, TAG_CAMERA, 4)
    u_pix = None
    if cfg.sampler in QMC_PIXEL_SAMPLERS:
        u_pix = rng.event_uniform(pkeys, TAG_CAMERA, 2)
    u_pos = camera_jitter(cfg, sample_idx, u_cam, u_pix)
    return pkeys, rkeys, u_cam, u_pos


def render_wave(scene: SceneData, cfg: RenderConfig, pixel_id, sample_idx,
                guide=None, guide_state=None, em_kinds=None):
    """Trace one (pixels x 1 sample) wave; returns (film_xy, L, aux)."""
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    if scene.medium.enabled:
        raise NotImplementedError("volume path tracing: ROADMAP Queue 1 item 9")
    if em_kinds is None:
        em_kinds = kinds_present(scene.emitters)
    mat_types = types_present(scene.mats)
    fused_tables = None
    if (guide is None and cfg.use_nee and cfg.sampler == "independent"
            and cfg.qmc_bounces == 0 and pixel_id.is_cuda):
        fused_tables = _fused_tables_for(scene)
    if guide is None:
        from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
        from mitsuba_path_guiding_torch.guiding.trivial import trivial_grid

        guide = make_guide_fn(0.0, mat_types)
        guide_state = trivial_grid(pixel_id.device)
    pkeys, rkeys, u_cam, u_pos = wave_keys_and_jitter(cfg, pixel_id, sample_idx)
    o, d, film_xy = generate_rays(scene.sensor, cfg.width, cfg.height, pixel_id, u_pos,
                                  u_lens=u_cam[..., 2:4], kind=scene.sensor.kind)
    if fused_tables is not None:
        from mitsuba_path_guiding_torch.ops.fused_path import trace_fused

        L, aux, _ = trace_fused(fused_tables, o, d, rkeys, max_depth=cfg.max_depth,
                                rr_depth=cfg.rr_depth, guided=False)
    else:
        uniforms = None
        if cfg.qmc_bounces > 0:
            uniforms = qmc.sobol_path_uniforms(rkeys, pkeys, sample_idx, cfg.max_depth,
                                               cfg.qmc_bounces)
        L, aux, _ = trace(scene, o, d, rkeys, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                          use_nee=cfg.use_nee, guide=guide, guide_state=guide_state,
                          em_kinds=em_kinds, mat_types=mat_types, uniforms=uniforms,
                          accel=cfg.accel)
    return film_xy, L, aux


def render(scene: SceneData, cfg: RenderConfig, guide=None, guide_state=None):
    """Full render: returns the (H, W, 3) image on the scene's device (a
    measurement probe's image carries its ``meas_scale``)."""
    dev = scene.geo.p0.device
    film = new_film(cfg.width, cfg.height, device=dev)
    rgbw = film.rgb_weight
    n_pix = cfg.width * cfg.height
    all_pixels = torch.arange(n_pix, dtype=torch.int64, device=dev)
    for batch_start in range(0, n_pix, PIXEL_BATCH):
        pix = all_pixels[batch_start: batch_start + PIXEL_BATCH]
        for s in range(cfg.spp):
            sidx = torch.full_like(pix, s)
            film_xy, L, _ = render_wave(scene, cfg, pix, sidx, guide, guide_state)
            rgbw = splat(rgbw, film_xy, L, cfg.width, cfg.height, cfg.filter_name)
    img = develop(Film(rgb_weight=rgbw, width=cfg.width, height=cfg.height))
    if scene.sensor.meas_scale is not None:
        img = img * scene.sensor.meas_scale
    return img
