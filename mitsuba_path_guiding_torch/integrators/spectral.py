"""Dispersive spectral rendering (port of the reference's
integrators/spectral.py).

Spectral transport runs as waves of the RGB path tracer, one scene per
wavelength bin: dielectric IORs from the Cauchy model at the bin's
wavelength, emitter radiance from its spectrum (blackbody, values, or RGB
upsampled), reflectances upsampled from RGB (``core/spectral.py``).  The
bin images combine to sRGB through the CIE colour matching functions.

``render_spectral`` renders each bin with ``render`` (one scene per bin,
seeds cfg.seed + 977 k), so a Cornell-class bin takes the fused kernel.
``render_spectral_scan`` traces every bin group of a sample in turn with
``trace``: where no material is dispersive, the three RGB channels of a
wave carry three different bins of one path (exact: the geometry does not
depend on the wavelength), and the padded duplicate bins of the last
group add nothing; a dispersive scene traces one bin a wave, each channel
weighted by a third of its CMF row.  The reference stacks the group
scenes into one ``lax.scan``; here they are a Python loop in the same
order, with the same keys (the group index folded into each ray's key).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.core.spectral import (
    bin_centers,
    blackbody,
    cauchy_ior,
    rgb_to_spectrum,
    spectrum_to_rgb,
)

DISPERSIVE = ("dielectric", "roughdielectric", "thindielectric")


def _bin_scene(desc: dict, lam: float, ks, n_bins: int) -> dict:
    """Scene description with materials and emitters evaluated at bin(s)
    ``ks``: an int (all three channels carry that bin) or a 3-tuple of bin
    indices (each RGB channel carries its bin; valid when no material is
    dispersive)."""
    kt = (ks, ks, ks) if np.ndim(ks) == 0 else tuple(ks)
    out = copy.deepcopy(desc)
    for sh in out.get("shapes", []):
        b = sh.get("bsdf") or {}
        if b.get("type") in DISPERSIVE:
            cc = float(b.get("cauchy_c", 0.00420))
            if "cauchy_b" in b:
                cb = float(b["cauchy_b"])
            else:
                # calibrate B so eta(589.3 nm, sodium D) == the scene's IOR
                cb = float(b.get("int_ior", 1.5046)) - cc / (0.5893**2)
            b["int_ior"] = float(cauchy_ior(lam, cb, cc))
            b.pop("cauchy_b", None)
            b.pop("cauchy_c", None)
        refl = b.get("reflectance")
        if refl is not None and np.ndim(refl) == 1:
            spec = rgb_to_spectrum(np.asarray(refl, dtype=np.float64), n_bins)
            b["reflectance"] = [float(spec[k]) for k in kt]
        em = sh.get("emitter")
        if em is not None:
            em["radiance"] = [_emitter_bin(em, k, n_bins) for k in kt]
    for em in out.get("emitters", []):
        key = "radiance" if "radiance" in em or "spectrum" in em else (
            "intensity" if "intensity" in em else None
        )
        if key is not None:
            em[key] = [_emitter_bin(em, k, n_bins, key) for k in kt]
    return out


def _has_dispersion(desc: dict) -> bool:
    """True when some material's scatter geometry depends on the
    wavelength (the dielectric families): such a scene traces one bin a
    wave."""
    return any((sh.get("bsdf") or {}).get("type") in DISPERSIVE for sh in desc.get("shapes", []))


def _emitter_bin(em: dict, k: int, n_bins: int, key: str = "radiance") -> float:
    spec = em.get("spectrum")
    if spec is not None:
        t = spec.get("type", "blackbody")
        if t == "blackbody":
            return float(blackbody(float(spec.get("temperature", 6504.0)), n_bins)[k])
        if t == "values":
            v = np.asarray(spec["values"], dtype=np.float64)
            assert v.shape == (n_bins,), "spectrum values must match n_bins"
            return float(v[k])
        raise ValueError(f"unknown spectrum type {t}")
    base = em.get(key, [1.0, 1.0, 1.0])
    spec_v = rgb_to_spectrum(np.asarray(base, dtype=np.float64), n_bins)
    return float(spec_v[k])


def _groups(desc: dict, n_bins: int):
    """The bin groups of ``render_spectral_scan`` and each group's (3, 3)
    rows mapping its channels' estimates to sRGB."""
    eye = np.eye(n_bins)
    cmf_all = np.stack([spectrum_to_rgb(eye[k], n_bins) for k in range(n_bins)])
    if _has_dispersion(desc):
        groups = [(k, k, k) for k in range(n_bins)]
        # the 3 channels duplicate the bin: average them
        return groups, np.stack([np.stack([cmf_all[k] / 3.0] * 3) for k in range(n_bins)])
    ids = list(range(n_bins)) + [n_bins - 1] * ((-n_bins) % 3)
    groups = [tuple(ids[i:i + 3]) for i in range(0, len(ids), 3)]
    rows = []
    for g in groups:
        # padded duplicate bins contribute once
        rows.append(np.stack([np.zeros(3) if k in g[:i] else cmf_all[k]
                              for i, k in enumerate(g)]))
    return groups, np.stack(rows)


def render_spectral_scan(desc: dict, cfg, n_bins: int = 8, max_depth=None, device=None):
    """Spectral render of a scene description, every bin group traced by
    ``trace`` in each sample's wave.  Returns (H, W, 3) linear sRGB, a
    float32 numpy array."""
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.core.rng import TAG_CAMERA
    from mitsuba_path_guiding_torch.integrators.path import trace
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present
    from mitsuba_path_guiding_torch.models.sensor import generate_rays
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    dev = resolve_device(device)
    lam = bin_centers(n_bins)
    groups, cmf_groups = _groups(desc, n_bins)
    scenes = [build_scene(_bin_scene(desc, float(lam[g[1]]), g, n_bins), device=dev)
              for g in groups]
    cmf_rows = torch.as_tensor(cmf_groups.astype(np.float32), device=dev)  # (G, 3, 3)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    md = max_depth if max_depth is not None else cfg.max_depth
    em_kinds = kinds_present(scenes[0].emitters)
    mat_types = types_present(scenes[0].mats)
    key = rng.base_key(cfg.seed, device=dev)
    pix = torch.arange(n_pix, dtype=torch.int64, device=dev)
    film = torch.zeros((n_pix, 3), device=dev)
    for s in range(cfg.spp):
        keys = rng.ray_keys(key, pix, torch.full_like(pix, s))
        for k, scene_b in enumerate(scenes):
            rkeys = rng.fold_in(keys, k)
            u_cam = rng.event_uniform(rkeys, TAG_CAMERA, 2)
            o, d, _ = generate_rays(scene_b.sensor, w, h, pix, u_cam)
            L, _, _ = trace(scene_b, o, d, rkeys, max_depth=md, em_kinds=em_kinds,
                            mat_types=mat_types)
            # the channels carry this group's bins; its rows map each to sRGB
            film = film + L @ cmf_rows[k]
    img = (film / cfg.spp).reshape(h, w, 3).cpu().numpy()
    return np.maximum(img, 0.0).astype(np.float32)


def render_spectral(desc: dict, cfg, n_bins: int = 8, integrator=None, device=None):
    """Spectral render of a scene description, one scene and one render
    per bin.  Returns (H, W, 3) linear sRGB, a float32 numpy array.
    ``integrator``: a callable (scene, cfg) -> (H, W, 3) tensor, ``render``
    by default."""
    from mitsuba_path_guiding_torch.integrators.render import render
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    if integrator is None:
        integrator = render
    dev = resolve_device(device)
    lam = bin_centers(n_bins)
    bins = []
    for k in range(n_bins):
        scene_k = build_scene(_bin_scene(desc, float(lam[k]), k, n_bins), device=dev)
        img_k = integrator(scene_k, cfg._replace(seed=cfg.seed + 977 * k))
        # single-bin transport: the three RGB channels are degenerate
        bins.append(img_k.cpu().numpy().mean(axis=-1))
    rgb = spectrum_to_rgb(np.stack(bins, axis=-1), n_bins)
    return np.maximum(rgb, 0.0).astype(np.float32)
