"""Render orchestration: camera rays -> trace -> film splat (port of the
reference's integrators/render.py ``RenderConfig``, ``wave_keys_and_jitter``,
``camera_jitter``, ``render_wave`` and ``render``).

A scene with a medium, or any scene with ``integrator="volpath"``, runs
the volumetric tracer ``integrators.volpath.trace_vol``, unguided with
BSDF sampling as in the reference.  Otherwise, on the card, unguided
waves with NEE and the independent sampler, without Sobol' bounce
dimensions, of a supported scene (diffuse materials, area lights, at most
2048 triangles) take the fused megakernel (``ops.fused_path.trace_fused``),
as the reference does on the TPU; every other wave runs the wavefront
``integrators.path.trace``.  ``use_bvh`` (None: above BRUTE_FORCE_MAX_TRIS
triangles) sends a scene without block tables through the BVH when true,
and a non-"auto" ``accel`` overrides it (``trace``'s routing).
``max_component_value`` > 0 clamps every radiance component of a sample
(the firefly clamp).  A scene with textures, vertex colours, bump or
normal maps or cloth (``texture_flags``) turns those on in ``trace``, and
a perspective camera over a textured scene filters its textures through
mip levels by the ray cone of a pixel (``cone_angle``); the volumetric
tracer applies no textures, as in the reference.  ``render`` reads the
scene's emitter kinds, BSDF types and texture flags and makes the
unguided wave's trivial guide once, before its waves.
``render_scanned`` (the reference's one-dispatch ``lax.scan`` of the same
waves in the same splat order) is ``render`` itself here.

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
from mitsuba_path_guiding_torch.integrators.path import (  # noqa: F401
    BRUTE_FORCE_MAX_TRIS,
    resolve_use_bvh,
    trace,
)
from mitsuba_path_guiding_torch.integrators.volpath import trace_vol
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene.types import BSDFType, SceneData
from mitsuba_path_guiding_torch.utils.stats import host_read, span

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


def _textured(scene) -> bool:
    """A reflectance override is present: a material with an atlas texture
    or a geometry-driven one (-3 vertex colours or curvature, -4
    wireframe), or vertex colours.  The reference tests the atlas's shape,
    which its placeholder atlas (2 rows) passes too, so it runs the
    override, to no effect, on every scene."""
    return scene.geo.vcol is not None or bool(
        host_read((scene.mats.texture_id != -1).any(), "render.textured"))


def _has_bump(scene) -> bool:
    return bool(host_read((scene.mats.packed[:, 19] >= 0).any(), "render.bumped"))


def _has_cloth(scene) -> bool:
    return bool(host_read((scene.mats.type == BSDFType.CLOTH).any(), "render.clothed"))


def _cone_angle(scene, cfg) -> float:
    """The primary ray's footprint half-angle, about fov_x / width, for a
    perspective camera over a textured scene (the reference's value); else
    0 (no mip filtering)."""
    if _textured(scene) and int(scene.sensor.kind) == 0:
        return 2.0 * float(host_read(scene.sensor.tan_half_fov_x, "render.cone_angle")) / cfg.width
    return 0.0


def texture_flags(scene) -> dict:
    """``trace``'s ``textured``, ``bumped`` and ``clothed`` of a scene (host
    reads, made once a render)."""
    return {"textured": _textured(scene), "bumped": _has_bump(scene),
            "clothed": _has_cloth(scene)}


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
    max_component_value: float = 0.0  # firefly clamp; 0 disables it
    pixel_batch: int = PIXEL_BATCH     # most pixels in one wave
    use_bvh: bool | None = None  # None: by triangle count (resolve_use_bvh)
    integrator: str = "path"     # "volpath" takes the volumetric tracer on any scene


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
    with span("keys", device=pixel_id.device):
        key = rng.base_key(cfg.seed, device=pixel_id.device)
        pkeys = rng.pixel_keys(key, pixel_id)
        rkeys = rng.fold_in(pkeys, sample_idx)
        u_cam = rng.event_uniform(rkeys, TAG_CAMERA, 4)
        u_pix = None
        if cfg.sampler in QMC_PIXEL_SAMPLERS:
            u_pix = rng.event_uniform(pkeys, TAG_CAMERA, 2)
        u_pos = camera_jitter(cfg, sample_idx, u_cam, u_pix)
    return pkeys, rkeys, u_cam, u_pos


def wants_grad(scene: SceneData) -> bool:
    """Grad mode is on and a tensor of the scene's geometry, materials,
    emitters or sensor requires grad."""
    if not torch.is_grad_enabled():
        return False
    return any(torch.is_tensor(x) and x.requires_grad
               for part in (scene.geo, scene.mats, scene.emitters, scene.sensor) for x in part)


def _fused_gate(scene: SceneData, cfg: RenderConfig, guide, device):
    """The fused kernel's tables when a wave takes it (unguided, no
    medium and not ``integrator="volpath"``, NEE, the independent sampler
    without Sobol' bounces, on the card, a supported scene, no gradient
    wanted: the kernel has no backward), else None."""
    if (guide is None and not scene.medium.enabled and cfg.integrator != "volpath"
            and cfg.use_nee and cfg.sampler == "independent" and cfg.qmc_bounces == 0
            and device.type == "cuda" and not wants_grad(scene)):
        return _fused_tables_for(scene)
    return None


def _unguided_wavefront(scene: SceneData, cfg: RenderConfig, guide, guide_state, mat_types,
                        device):
    """(guide, guide_state) of a wave: an unguided wave that takes the
    wavefront gets the guided code with selection probability 0 (the
    trivial guide); the fused kernel and the volumetric tracer (which
    samples the BSDF itself) take none."""
    if (guide is None and not scene.medium.enabled and cfg.integrator != "volpath"
            and _fused_gate(scene, cfg, None, device) is None):
        from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
        from mitsuba_path_guiding_torch.guiding.trivial import trivial_grid

        return make_guide_fn(0.0, mat_types), trivial_grid(device)
    return guide, guide_state


def render_wave(scene: SceneData, cfg: RenderConfig, pixel_id, sample_idx,
                guide=None, guide_state=None, em_kinds=None, mat_types=None, tex_flags=None):
    """Trace one (pixels x 1 sample) wave; returns (film_xy, L, aux).
    ``em_kinds``, ``mat_types`` and ``tex_flags`` (``texture_flags``; host
    reads of the scene) are computed when not given."""
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    if em_kinds is None:
        em_kinds = kinds_present(scene.emitters)
    if mat_types is None:
        mat_types = types_present(scene.mats)
    if tex_flags is None:
        tex_flags = texture_flags(scene)
    fused_tables = _fused_gate(scene, cfg, guide, pixel_id.device)
    use_bvh = resolve_use_bvh(scene, cfg)
    guide, guide_state = _unguided_wavefront(scene, cfg, guide, guide_state, mat_types,
                                             pixel_id.device)
    pkeys, rkeys, u_cam, u_pos = wave_keys_and_jitter(cfg, pixel_id, sample_idx)
    o, d, film_xy = generate_rays(scene.sensor, cfg.width, cfg.height, pixel_id, u_pos,
                                  u_lens=u_cam[..., 2:4], kind=scene.sensor.kind)
    if cfg.integrator == "volpath" or (cfg.integrator == "path" and scene.medium.enabled):
        L, aux, _ = trace_vol(scene, o, d, rkeys, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                              use_nee=cfg.use_nee, use_bvh=use_bvh, guide=guide,
                              guide_state=guide_state, em_kinds=em_kinds, mat_types=mat_types,
                              hetero=scene.medium.heterogeneous,
                              phase_kind=scene.medium.phase_kind, accel=cfg.accel)
    elif fused_tables is not None:
        from mitsuba_path_guiding_torch.ops.fused_path import trace_fused

        with span("trace_fused"):
            L, aux, _ = trace_fused(fused_tables, o, d, rkeys, max_depth=cfg.max_depth,
                                    rr_depth=cfg.rr_depth, guided=False)
    else:
        uniforms = None
        if cfg.qmc_bounces > 0:
            uniforms = qmc.sobol_path_uniforms(rkeys, pkeys, sample_idx, cfg.max_depth,
                                               cfg.qmc_bounces)
        L, aux, _ = trace(scene, o, d, rkeys, max_depth=cfg.max_depth, rr_depth=cfg.rr_depth,
                          use_nee=cfg.use_nee, use_bvh=use_bvh, guide=guide,
                          guide_state=guide_state, em_kinds=em_kinds, mat_types=mat_types,
                          uniforms=uniforms, accel=cfg.accel,
                          cone_angle=_cone_angle(scene, cfg) if tex_flags["textured"] else 0.0,
                          **tex_flags)
    if cfg.max_component_value > 0.0:
        L = torch.clamp_max(L, cfg.max_component_value)
    return film_xy, L, aux


def render(scene: SceneData, cfg: RenderConfig, guide=None, guide_state=None):
    """Full render: returns the (H, W, 3) image on the scene's device (a
    measurement probe's image carries its ``meas_scale``)."""
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    dev = scene.geo.p0.device
    with span("frame", device=dev):
        em_kinds = kinds_present(scene.emitters)
        mat_types = types_present(scene.mats)
        tex_flags = texture_flags(scene)
        guide, guide_state = _unguided_wavefront(scene, cfg, guide, guide_state, mat_types, dev)
        film = new_film(cfg.width, cfg.height, device=dev)
        rgbw = film.rgb_weight
        n_pix = cfg.width * cfg.height
        all_pixels = torch.arange(n_pix, dtype=torch.int64, device=dev)
        for batch_start in range(0, n_pix, cfg.pixel_batch):
            pix = all_pixels[batch_start: batch_start + cfg.pixel_batch]
            for s in range(cfg.spp):
                sidx = torch.full_like(pix, s)
                with span("wave"):
                    film_xy, L, _ = render_wave(scene, cfg, pix, sidx, guide, guide_state,
                                                em_kinds, mat_types, tex_flags)
                    with span("splat"):
                        rgbw = splat(rgbw, film_xy, L, cfg.width, cfg.height, cfg.filter_name)
        img = develop(Film(rgb_weight=rgbw, width=cfg.width, height=cfg.height))
        if scene.sensor.meas_scale is not None:
            img = img * scene.sensor.meas_scale
    return img


# The reference's render_scanned runs render's waves as one lax.scan, in
# the same splat order (the same image); an eager loop is that already.
render_scanned = render
