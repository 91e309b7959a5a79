"""Auxiliary integrators (port of the reference's
integrators/aux_integrators.py): direct illumination, ambient occlusion,
the field AOVs, the multichannel meta-integrator and adaptive sampling.

Queries route as ``integrators.path.route_dense_or_bvh`` ("auto": the
tiled kernel at 16384 triangles or fewer, the BVH above), where the
reference takes its dense oracle (the same winner).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.math import Frame, dot, normalize
from mitsuba_path_guiding_torch.core.rng import TAG_CAMERA
from mitsuba_path_guiding_torch.core.spectrum import luminance
from mitsuba_path_guiding_torch.core.warp import square_to_cosine_hemisphere
from mitsuba_path_guiding_torch.integrators.path import route_dense_or_bvh
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render, render_wave
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import SceneData

FIELD_NAMES = ("position", "distance", "geo_normal", "sh_normal", "uv", "albedo", "prim_index")


def render_direct(scene: SceneData, cfg: RenderConfig):
    """Direct illumination (emitter hits and one NEE vertex with MIS):
    ``render`` at max_depth 1."""
    return render(scene, cfg._replace(max_depth=1))


def _camera_wave(scene: SceneData, cfg: RenderConfig, s: int, centre: bool = False):
    """Pixel ids, keys and camera rays of sample ``s`` of every pixel
    (``centre``: through the pixel centres)."""
    dev = scene.geo.p0.device
    pix = torch.arange(cfg.width * cfg.height, dtype=torch.int64, device=dev)
    rkeys = rng.ray_keys(rng.base_key(cfg.seed, device=dev), pix, torch.full_like(pix, s))
    u_cam = rng.event_uniform(rkeys, TAG_CAMERA, 2)
    if centre:
        u_cam = u_cam * 0.0 + 0.5
    o, d, _ = generate_rays(scene.sensor, cfg.width, cfg.height, pix, u_cam)
    return rkeys, o, d


def render_ao(scene: SceneData, cfg: RenderConfig, ray_length: float = 0.0):
    """Cosine-weighted ambient occlusion: a camera hit, a cosine direction
    about its geometric normal, an any-hit query of ``ray_length`` (half
    the scene's diagonal when 0)."""
    if ray_length <= 0.0:
        ray_length = float(torch.linalg.vector_norm(scene.aabb_max - scene.aabb_min)) * 0.5
    intersect, occluded = route_dense_or_bvh(scene, cfg.accel)
    n_pix = cfg.width * cfg.height
    acc = torch.zeros((n_pix,), dtype=torch.float32, device=scene.geo.p0.device)
    for s in range(cfg.spp):
        rkeys, o, d = _camera_wave(scene, cfg, s)
        hit = intersect(o, d, None)
        p = o + torch.where(hit.valid, hit.t, 1.0)[..., None] * d
        row = gather_rows_t(scene.geo.shade_packed, torch.clamp_min(hit.prim, 0))
        ng = torch.stack([row[0], row[1], row[2]], dim=-1)
        ng = torch.where(dot(ng, -d)[..., None] < 0.0, -ng, ng)
        wo = Frame.from_normal(ng).to_world(
            square_to_cosine_hemisphere(rng.bounce_uniform(rkeys, 0, 2)))
        occ = occluded(p + ng * 1e-4, wo,
                       torch.where(hit.valid, ray_length, -1.0).to(torch.float32))
        acc = acc + torch.where(hit.valid, 1.0 - occ.to(torch.float32), 0.0)
    img = (acc / cfg.spp).reshape(cfg.height, cfg.width)
    return img[..., None].repeat(1, 1, 3)


def render_field(scene: SceneData, cfg: RenderConfig, field: str = "position"):
    """One AOV through the pixel centres: position, distance, geo_normal,
    sh_normal, uv, albedo or prim_index.  Returns (H, W, 3)."""
    if field not in FIELD_NAMES:
        raise ValueError(f"unknown field: {field}")
    intersect, _ = route_dense_or_bvh(scene, cfg.accel)
    _, o, d = _camera_wave(scene, cfg, 0, centre=True)
    hit = intersect(o, d, None)
    t_hit = torch.where(hit.valid, hit.t, 0.0)
    p = o + t_hit[..., None] * d
    row = gather_rows_t(scene.geo.shade_packed, torch.clamp_min(hit.prim, 0))
    valid3 = hit.valid[..., None]
    b0 = 1.0 - hit.u - hit.v
    if field == "position":
        out = torch.where(valid3, p, 0.0)
    elif field == "distance":
        out = t_hit[..., None].repeat(1, 3)
    elif field == "geo_normal":
        out = torch.where(valid3, torch.stack([row[0], row[1], row[2]], -1), 0.0)
    elif field == "sh_normal":
        ns = normalize(torch.stack([b0 * row[3 + k] + hit.u * row[6 + k] + hit.v * row[9 + k]
                                    for k in range(3)], dim=-1))
        out = torch.where(valid3, ns, 0.0)
    elif field == "uv":
        # zero on a miss, as the other surface fields (the reference reads
        # triangle 0's UVs at its oracle's barycentrics of no hit)
        uu = b0 * row[12] + hit.u * row[14] + hit.v * row[16]
        vv = b0 * row[13] + hit.u * row[15] + hit.v * row[17]
        out = torch.where(valid3, torch.stack([uu, vv, torch.zeros_like(uu)], dim=-1), 0.0)
    elif field == "albedo":
        from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod

        mid = row[18].to(torch.int32)
        out = torch.where(valid3, bsdf_mod.albedo(scene.mats, mid,
                                                  types=bsdf_mod.types_present(scene.mats)), 0.0)
    else:  # prim_index
        out = hit.prim.to(torch.float32)[..., None].repeat(1, 3)
    return out.reshape(cfg.height, cfg.width, 3)


def render_multichannel(scene: SceneData, cfg: RenderConfig, channels=None):
    """Several sub-integrators into one named channel set: "path" (or
    "radiance"), "direct", "ao" and the ``render_field`` names.  Returns
    {name: (H, W, 3)}; ``write_multichannel_exr`` writes them."""
    out = {}
    for ch in list(channels or ["path", "albedo", "sh_normal", "distance"]):
        if ch in ("path", "radiance"):
            out[ch] = render(scene, cfg)
        elif ch == "direct":
            out[ch] = render_direct(scene, cfg)
        elif ch == "ao":
            out[ch] = render_ao(scene, cfg)
        elif ch in FIELD_NAMES:
            out[ch] = render_field(scene, cfg, field=ch)
        else:
            raise ValueError(f"multichannel: unknown sub-integrator {ch}")
    return out


def write_multichannel_exr(path: str, images: dict) -> None:
    """{name: (H, W, 3)} -> one EXR of name.R/G/B channels; the "path"
    group keeps plain R/G/B."""
    from mitsuba_path_guiding_torch.film.film import write_exr_channels

    chans = {}
    for name, img in images.items():
        img = np.asarray(torch.as_tensor(img).cpu(), dtype=np.float32)
        prefix = "" if name in ("path", "radiance") else name + "."
        for i, c in enumerate("RGB"):
            chans[prefix + c] = img[..., i]
    write_exr_channels(path, chans)


def _normal_quantile(p_value: float) -> float:
    """Two-sided standard-normal quantile z, P(|Z| <= z) = 1 - p."""
    from scipy.special import erfinv

    return float(math.sqrt(2.0) * erfinv(1.0 - p_value))


def render_adaptive(scene: SceneData, cfg: RenderConfig, base_spp: int = 8,
                    max_sample_factor: int = 32, max_error: float = 0.05,
                    p_value: float = 0.05, guide=None, guide_state=None):
    """Per-pixel statistical stopping: a pixel takes rounds of ``base_spp``
    samples until the half-width of the (1 - p) confidence interval of its
    mean luminance is below ``max_error * max(mean, 0.01 * average
    luminance)``, or it has ``max_sample_factor * base_spp`` samples.  A
    round covers the still-active pixels, padded to a power of two (at
    least 32) with a sentinel row past the image that no result reads; the
    variance is Welford's online recurrence.  Returns (image (H, W, 3),
    {"spp", "ci_width"} as (H, W) numpy maps)."""
    n_pix = cfg.width * cfg.height
    dev = scene.geo.p0.device
    quantile = _normal_quantile(p_value)
    # one row more than the image: the padding lanes' sentinel
    s1 = torch.zeros((n_pix + 1, 3), dtype=torch.float32, device=dev)
    mean = torch.zeros((n_pix + 1,), dtype=torch.float32, device=dev)
    m2 = torch.zeros((n_pix + 1,), dtype=torch.float32, device=dev)
    count = torch.zeros((n_pix + 1,), dtype=torch.int32, device=dev)

    def batch(idx, live):
        nonlocal s1, mean, m2, count
        n0 = count[idx]
        for s in range(base_spp):
            _, L, _ = render_wave(scene, cfg, idx, (n0 + s).to(torch.int64), guide, guide_state)
            lum = luminance(L)
            s1 = s1.index_put((idx,), s1[idx] + L * live[:, None])
            cnt = count[idx] + 1
            mu = mean[idx]
            delta = lum - mu
            mu = mu + delta / cnt
            d2 = m2[idx] + delta * (lum - mu)
            on = live > 0
            count = count.index_put((idx,), torch.where(on, cnt, count[idx]))
            mean = mean.index_put((idx,), torch.where(on, mu, mean[idx]))
            m2 = m2.index_put((idx,), torch.where(on, d2, m2[idx]))

    def ci_width():
        var = m2 / torch.clamp_min(count - 1, 1)
        return torch.sqrt(var / torch.clamp_min(count, 1)) * quantile

    # a pilot round over every pixel gives the average luminance
    batch(torch.arange(n_pix, dtype=torch.int64, device=dev),
          torch.ones((n_pix,), dtype=torch.float32, device=dev))
    avg_lum = float(torch.mean(mean[:n_pix]))
    max_spp = max_sample_factor * base_spp
    while True:
        base = torch.clamp_min(mean, 0.01 * avg_lum)
        active = (ci_width() > max_error * base) & (count < max_spp)
        act_np = np.nonzero(active[:n_pix].cpu().numpy())[0]
        if len(act_np) == 0:
            break
        pad = 1 << max(int(np.ceil(np.log2(len(act_np)))), 5)
        idx = np.full((pad,), n_pix, np.int64)
        idx[:len(act_np)] = act_np
        live = np.zeros((pad,), np.float32)
        live[:len(act_np)] = 1.0
        batch(torch.from_numpy(idx).to(dev), torch.from_numpy(live).to(dev))

    img = s1[:n_pix] / torch.clamp_min(count[:n_pix], 1).to(torch.float32)[:, None]
    info = {"spp": count[:n_pix].cpu().numpy().reshape(cfg.height, cfg.width),
            "ci_width": ci_width()[:n_pix].cpu().numpy().reshape(cfg.height, cfg.width)}
    return img.reshape(cfg.height, cfg.width, 3), info
