"""Kelemen primary-sample-space MLT with thousands of parallel chains
(port of the reference's integrators/pssmlt.py).

Every chain is a wavefront lane: its state is one column of a (D, N)
matrix of primary-sample coordinates (rows 0:2 the film position, 2:4 the
lens, then 9 a bounce), and one mutation step of all chains is one
``integrators.path.trace`` of the wave with those coordinates as its
explicit ``uniforms``.  The steps run as a Python loop: a step reads
nothing back to the host, so the card queues the whole render; the host
reads the bootstrap's mean luminance once.

Estimator (Kelemen et al. 2002): a bootstrap of ``bootstrap_factor`` x
``n_chains`` uniform samples gives the normalisation b and the chains'
seeds, drawn in proportion to luminance; each step splats the current
state with weight (1 - a) / I and the proposal with a / I', and the image
is the splats times b x pixels / samples.  Large steps (fresh uniforms)
with probability ``p_large`` keep the chains ergodic.

Queries route as ``integrators.path.route_dense_or_bvh`` (the tiled
kernel at 16384 triangles or fewer, else the BVH), through ``trace``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.core.spectrum import luminance
from mitsuba_path_guiding_torch.film.film import splat_raw
from mitsuba_path_guiding_torch.integrators.path import dense_or_bvh_accel, resolve_use_bvh, trace
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene.types import SceneData


class Statics(NamedTuple):
    """Host reads of a scene made once a render: the emitter kinds, the
    BSDF types, ``trace``'s route and texture flags, the sensor kind; and
    key 0 on the scene's device, whose per-pixel keys ``trace`` takes
    (its explicit uniforms leave them unused)."""

    em_kinds: tuple
    mat_types: tuple
    accel: str
    tex_flags: dict
    sensor_kind: int
    key0: torch.Tensor


def scene_statics(scene: SceneData, cfg) -> Statics:
    from mitsuba_path_guiding_torch.integrators.render import texture_flags
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    return Statics(kinds_present(scene.emitters), types_present(scene.mats),
                   dense_or_bvh_accel(scene, cfg.accel, resolve_use_bvh(scene, cfg)),
                   texture_flags(scene),
                   int(scene.sensor.kind), rng.base_key(0, device=scene.geo.p0.device))


def pss_dims(cfg) -> int:
    """Rows of a chain's state: film 2, lens 2, then 9 a bounce."""
    return 4 + 9 * cfg.max_depth


def _path_eval(scene: SceneData, cfg, u_mat: torch.Tensor, st: Statics):
    """The path integral at primary-sample coordinates u_mat (D, N).
    Returns (rgb (N, 3), film_xy (N, 2))."""
    w, h = cfg.width, cfg.height
    fx = u_mat[0] * w
    fy = u_mat[1] * h
    ix = torch.clamp(fx.to(torch.int32), 0, w - 1)
    iy = torch.clamp(fy.to(torch.int32), 0, h - 1)
    pid = iy * w + ix
    jitter = torch.stack([fx - ix, fy - iy], dim=-1)
    o, d, film_xy = generate_rays(scene.sensor, w, h, pid, jitter,
                                  u_lens=torch.stack([u_mat[2], u_mat[3]], dim=-1),
                                  kind=st.sensor_kind)
    keys = rng.ray_keys(st.key0, pid, torch.zeros_like(pid))
    L, _, _ = trace(scene, o, d, keys, max_depth=cfg.max_depth,
                    rr_depth=10**6,  # no roulette: the PSS dimensions are finite
                    use_nee=cfg.use_nee, em_kinds=st.em_kinds, mat_types=st.mat_types,
                    uniforms=u_mat[4:], accel=st.accel, **st.tex_flags)
    if cfg.max_component_value > 0.0:
        L = torch.clamp_max(L, cfg.max_component_value)
    return L, film_xy


def _mutate_small(u: torch.Tensor, key_bits, s1: float = 1.0 / 1024.0, s2: float = 1.0 / 64.0):
    """Kelemen's symmetric log-scale perturbation of every coordinate:
    du = s2 exp(-log(s2 / s1) r), its sign from a second uniform, wrapped
    to [0, 1)."""
    r = key_bits[0]
    sign = torch.where(key_bits[1] < 0.5, 1.0, -1.0)
    du = s2 * torch.exp(-math.log(s2 / s1) * r)
    v = u + sign * du
    return v - torch.floor(v)


def splat_pair(acc, xy_cur, c_cur, w_cur, xy_prop, c_prop, w_prop, width: int, height: int):
    """Kelemen's two splats of a step into the raw accumulator: the
    current state's, then the proposal's."""
    splat_raw(acc, xy_cur, c_cur * w_cur[..., None], width, height)
    splat_raw(acc, xy_prop, c_prop * w_prop[..., None], width, height)


def _chain_step(scene, cfg, st: Statics, chain, keys, step: int, acc, p_large: float):
    """One mutation of every chain; chain = (u (D, N), I (N,), C (N, 3),
    xy (N, 2)).  Splats into acc and returns the next chain state."""
    u_cur, i_cur, c_cur, xy_cur = chain
    dims = u_cur.shape[0]
    bits = rng.uniform(rng.fold_in(keys, step), 2 * dims + 2).T  # (2D + 2, N)
    large = bits[0] < p_large
    u_small = _mutate_small(u_cur, (bits[2:dims + 2], bits[dims + 2:]))
    # large steps take the fresh uniforms of rows 2:D+2
    u_prop = torch.where(large[None, :], bits[2:dims + 2], u_small)
    c_prop, xy_prop = _path_eval(scene, cfg, u_prop, st)
    i_prop = luminance(c_prop)
    a = torch.clamp(i_prop / torch.clamp_min(i_cur, 1e-12), 0.0, 1.0)
    w_cur = (1.0 - a) / torch.clamp_min(i_cur, 1e-12)
    w_prop = a / torch.clamp_min(i_prop, 1e-12)
    splat_pair(acc, xy_cur, c_cur, w_cur, xy_prop, c_prop, w_prop, cfg.width, cfg.height)
    accept = bits[1] < a
    return (torch.where(accept[None, :], u_prop, u_cur),
            torch.where(accept, i_prop, i_cur),
            torch.where(accept[..., None], c_prop, c_cur),
            torch.where(accept[..., None], xy_prop, xy_cur))


def _chain_steps(scene, cfg, st: Statics, chain, keys, step0: int, acc, n_steps: int,
                 p_large: float):
    """n_steps mutations of every chain from step index step0 (the
    reference's lax.scan); returns the chain state, acc updated."""
    for i in range(n_steps):
        chain = _chain_step(scene, cfg, st, chain, keys, step0 + i, acc, p_large)
    return chain


def bootstrap(key, dims: int, n_boot: int, n_chains: int, f_eval):
    """The chains' seeds: n_boot uniform samples of ``f_eval(u)`` ->
    (weight (N,), state), b = their mean weight (read on the host), and
    n_chains seed indices drawn in proportion to the weights.  Returns
    (b, seed indices, u_boot, f_eval's result)."""
    kb, kseed = key
    u_boot = rng.uniform_shape(kb, (dims, n_boot))
    w_boot, state = f_eval(u_boot)
    total = rng.sum_xla(w_boot)
    b = float(total / n_boot)
    if b <= 0.0:
        return b, None, u_boot, state
    probs = w_boot / torch.clamp_min(total, 1e-30)
    return b, rng.choice(kseed, n_boot, (n_chains,), probs), u_boot, state


def chain_keys(kchain, n_chains: int):
    """Each chain's key: the chain key folded with the chain's index."""
    idx = torch.arange(n_chains, dtype=torch.int64, device=kchain.device)
    return rng.fold_in(kchain.expand(n_chains, 2), idx)


def render_pssmlt(scene: SceneData, cfg, n_chains: int = 8192,
                  mutations_per_pixel: int | None = None, p_large: float = 0.3,
                  bootstrap_factor: int = 4):
    """Full PSSMLT render; cfg.spp counts mutations a pixel unless
    ``mutations_per_pixel`` is given.  Returns (H, W, 3) on the scene's
    device."""
    dev = resolve_device(scene.geo.p0.device)
    w, h = cfg.width, cfg.height
    st = scene_statics(scene, cfg)
    dims = pss_dims(cfg)
    mpp = mutations_per_pixel or cfg.spp
    n_steps_total = max(w * h * mpp // n_chains, 1)

    kb, kseed, kchain = rng.split(rng.base_key(cfg.seed, device=dev), 3)

    def f_eval(u):
        c, xy = _path_eval(scene, cfg, u, st)
        return luminance(c), (c, xy)

    b, idx, u_boot, (c_boot, xy_boot) = bootstrap(
        (kb, kseed), dims, bootstrap_factor * n_chains, n_chains, f_eval)
    if b <= 0.0:
        return torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    chain = (u_boot[:, idx], torch.clamp_min(luminance(c_boot)[idx], 1e-12), c_boot[idx],
             xy_boot[idx])
    acc = torch.zeros((h * w, 3), dtype=torch.float32, device=dev)
    _chain_steps(scene, cfg, st, chain, chain_keys(kchain, n_chains), 0, acc, n_steps_total,
                 p_large)
    n_samples = n_steps_total * n_chains
    return acc.reshape(h, w, 3) * (b * (w * h) / n_samples)
