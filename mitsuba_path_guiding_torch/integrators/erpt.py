"""Energy-redistribution path tracing (port of the reference's
integrators/erpt.py).

Each pass seeds one path a pixel (film coordinates stratified over the
pixels) and redistributes its energy along a short Metropolis chain of
Kelemen small steps in primary-sample space (``integrators.pssmlt``'s
``_mutate_small`` and ``_path_eval``), every step a wavefront trace of all
chains.  Equal deposition: a seed of luminance I0 deposits e = I0 / M a
step, (1 - a) e C / I at the current path's pixel and a e C' / I' at the
proposal's, so the chain spends exactly the seed's energy.  Nothing is
read back to the host.
"""
from __future__ import annotations

import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.core.spectrum import luminance
from mitsuba_path_guiding_torch.integrators.pssmlt import (
    Statics,
    _mutate_small,
    _path_eval,
    chain_keys,
    pss_dims,
    scene_statics,
    splat_pair,
)
from mitsuba_path_guiding_torch.scene.types import SceneData


def _redistribute(scene: SceneData, cfg, st: Statics, u0: torch.Tensor, keys, acc,
                  n_steps: int):
    """Seed at u0 (D, N) and run n_steps equal-deposition mutations,
    splatting into acc (returned)."""
    c_cur, xy_cur = _path_eval(scene, cfg, u0, st)
    i_cur = luminance(c_cur)
    e = i_cur / n_steps  # the energy deposited a step
    u_cur = u0
    dims = u0.shape[0]
    for i in range(n_steps):
        bits = rng.uniform(rng.fold_in(keys, i), 2 * dims + 1).T  # (2D + 1, N)
        u_prop = _mutate_small(u_cur, (bits[1:dims + 1], bits[dims + 1:]))
        c_prop, xy_prop = _path_eval(scene, cfg, u_prop, st)
        i_prop = luminance(c_prop)
        a = torch.clamp(i_prop / torch.clamp_min(i_cur, 1e-12), 0.0, 1.0)
        a = torch.where(i_cur > 0.0, a, 0.0)
        w_cur = (1.0 - a) * e / torch.clamp_min(i_cur, 1e-12)
        w_prop = a * e / torch.clamp_min(i_prop, 1e-12)
        splat_pair(acc, xy_cur, c_cur, w_cur, xy_prop, c_prop, w_prop, cfg.width, cfg.height)
        accept = bits[0] < a
        u_cur = torch.where(accept[None, :], u_prop, u_cur)
        i_cur = torch.where(accept, i_prop, i_cur)
        c_cur = torch.where(accept[..., None], c_prop, c_cur)
        xy_cur = torch.where(accept[..., None], xy_prop, xy_cur)
    return acc


def seed_uniforms(key, cfg, dims: int):
    """A pass's seed coordinates (D, pixels): uniforms with the film
    dimensions stratified over the pixels, and its chain key.  ``key`` is
    the render key folded with the pass."""
    w, h = cfg.width, cfg.height
    n_pix = w * h
    ks, kc = rng.split(key, 2)
    u0 = rng.uniform_shape(ks, (dims, n_pix))
    pix = torch.arange(n_pix, device=key.device)
    px = (pix % w).to(torch.float32)
    py = torch.div(pix, w, rounding_mode="floor").to(torch.float32)
    u0 = torch.cat([((px + u0[0]) / w)[None], ((py + u0[1]) / h)[None], u0[2:]])
    return u0, kc


def render_erpt(scene: SceneData, cfg, chain_length: int = 16):
    """Full ERPT render: cfg.spp seed paths a pixel, each redistributed
    along a ``chain_length``-step chain.  Returns (H, W, 3) on the scene's
    device."""
    dev = resolve_device(scene.geo.p0.device)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    st = scene_statics(scene, cfg)
    dims = pss_dims(cfg)
    key = rng.base_key(cfg.seed, device=dev)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        u0, kc = seed_uniforms(rng.fold_in(key, s), cfg, dims)
        _redistribute(scene, cfg, st, u0, chain_keys(kc, n_pix), acc, chain_length)
    return (acc / float(cfg.spp)).reshape(h, w, 3)
