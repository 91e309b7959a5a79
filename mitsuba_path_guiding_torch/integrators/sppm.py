"""Stochastic progressive photon mapping with a sorted-grid gather (port of
the reference's integrators/sppm.py).

A camera pass follows each pixel's path through its specular chain to the
first non-delta vertex, the hitpoint; a photon pass shoots a wave of
photons from the emitters and deposits one at every non-delta hit.  The
photons are binned into cells of twice the initial gather radius, put in
a random order (``core.rng.permutation`` of key 17, so that the first
photons of a cell are a fair sample of it) and sorted by cell key (a
stable sort); each hitpoint scans the 2 x 2 x 2 cells around its nearest
cell corner, each cell's first MAX_CELL_TAPS photons reweighted by the
cell's count over the taps, with ``torch.searchsorted`` giving each cell's
segment.  A disc test keeps the photons within the radius, in front, and
near the tangent plane.

The gathered flux is binned by incident direction in the hitpoint's frame
(2 cos-theta bands x 8 azimuth sectors), and one BSDF evaluation a bin
weighs it (diffuse reduces to albedo / pi); the rough single-lobe
families (PER_PHOTON_FAMILIES) evaluate the BSDF per photon instead.  The
Hachisuka-Jensen update after a pass with M new photons in radius R:
N' = N + alpha M, R' = R sqrt(N' / (N + M)), tau' = (tau + phi) N' / (N +
M), and L = L_emitted / passes + tau / (passes pi R^2); as in the
reference, N' is not kept, so N is 0 at every pass.

Queries route as ``integrators.path.route_dense_or_bvh``; the hits'
shading rows come through ``gather_rows_t`` and each hit's material row is
gathered once (``bsdf.gather_params``).  The sort, the segment search and
the tap loops are plain torch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mitsuba_path_guiding_torch.core import rng
from mitsuba_path_guiding_torch.core.device import resolve_device
from mitsuba_path_guiding_torch.core.math import Frame, dot
from mitsuba_path_guiding_torch.core.rng import bounce_uniform, event_uniform
from mitsuba_path_guiding_torch.integrators.path import INFD, _offset_ray, route_dense_or_bvh
from mitsuba_path_guiding_torch.integrators.ptracer import TAG_EMITTER_RAY, _decode_hit
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.sensor import generate_rays
from mitsuba_path_guiding_torch.scene.types import BSDFType, SceneData

MAX_CELL_TAPS = 32  # photons examined a cell (x 8 cells a hitpoint)
GRID_MAX = 512      # cells an axis at most (the key fits int32)
N_COS_BANDS = 2     # incident-direction bins: cos-theta bands
N_AZIMUTH = 8       # x azimuth sectors in the hitpoint frame
N_DIR_BINS = N_COS_BANDS * N_AZIMUTH
NO_CELL = 2 ** 30   # the key of a photon that was not deposited
PHOTON_ORDER_SEED = 17
# families whose hitpoints take the per-photon evaluation (every rough
# single-lobe family; nested and coated families take the bins)
PER_PHOTON_FAMILIES = (
    BSDFType.ROUGH_CONDUCTOR, BSDFType.PHONG, BSDFType.WARD,
    BSDFType.ROUGH_PLASTIC, BSDFType.ROUGH_DIELECTRIC,
    BSDFType.ROUGH_DIFFUSE,
)
_DELTA_TYPES = (BSDFType.CONDUCTOR, BSDFType.DIELECTRIC, BSDFType.NULL,
                BSDFType.THINDIELECTRIC)


def _dir_bin_centers():
    """(K, 3) local-frame unit centres of the incident-direction bins
    (sector s covers azimuths from -pi + s 2 pi / N_AZIMUTH)."""
    ct = (np.arange(N_COS_BANDS) + 0.5) / N_COS_BANDS
    ph = ((np.arange(N_AZIMUTH) + 0.5) / N_AZIMUTH - 0.5) * 2.0 * np.pi
    ctg, phg = np.meshgrid(ct, ph, indexing="ij")
    st = np.sqrt(np.maximum(1.0 - ctg**2, 0.0))
    return np.stack([st * np.cos(phg), st * np.sin(phg), ctg],
                    axis=-1).reshape(N_DIR_BINS, 3).astype(np.float32)


def _is_delta_mat(t):
    out = torch.zeros_like(t, dtype=torch.bool)
    for k in _DELTA_TYPES:
        out = out | (t == k)
    return out


class Hitpoints(NamedTuple):
    """A camera pass's hitpoints, one a pixel."""

    pos: torch.Tensor    # (N, 3)
    ns: torch.Tensor     # (N, 3)
    alb: torch.Tensor    # (N, 3)
    T: torch.Tensor      # (N, 3) throughput of the specular chain
    valid: torch.Tensor  # (N,) bool
    L: torch.Tensor      # (N, 3) emission seen along the chain
    mid: torch.Tensor    # (N,) int32 material row
    wol: torch.Tensor    # (N, 3) the camera direction in the hitpoint's frame


def camera_pass(scene: SceneData, rkeys, width: int, height: int, u_pos, pixel_id,
                max_depth: int = 4, accel: str = "auto", em_kinds=em_mod.PORTED_KINDS,
                mat_types=bsdf_mod.PORTED_TYPES, sensor_kind: int = 0) -> Hitpoints:
    """Camera rays through their specular chains to the first non-delta
    vertex."""
    geo, em = scene.geo, scene.emitters
    intersect, _ = route_dense_or_bvh(scene, accel)
    o, d, _ = generate_rays(scene.sensor, width, height, pixel_id, u_pos, kind=sensor_kind)
    n, dev = o.shape[0], o.device
    f32 = dict(dtype=torch.float32, device=dev)
    T = torch.ones((n, 3), **f32)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    hp_pos, hp_ns, hp_alb, hp_T, L, hp_wol = (torch.zeros((n, 3), **f32) for _ in range(6))
    hp_valid = torch.zeros((n,), dtype=torch.bool, device=dev)
    hp_mid = torch.zeros((n,), dtype=torch.int32, device=dev)

    for depth in range(max_depth):
        u = bounce_uniform(rkeys, depth, 9)
        hit = intersect(o, d, torch.where(alive, INFD, -1.0))
        act = alive & hit.valid
        env_l = em_mod.eval_env(em, d, kinds=em_kinds)
        L = torch.where((alive & ~hit.valid)[..., None], L + T * env_l, L)
        p, ng, ns, row, _ = _decode_hit(geo, hit, o, d)
        mid = row[18].to(torch.int32)
        # emission on a hit (seen directly or through a specular chain)
        cos_l = dot(ng, -d)
        le = torch.where(((row[19] >= 0.0) & (cos_l > 0.0))[..., None],
                         torch.stack([row[20], row[21], row[22]], dim=-1), 0.0)
        L = torch.where(act[..., None], L + T * le, L)

        mp = bsdf_mod.gather_params(scene.mats, mid, types=mat_types)
        is_delta = _is_delta_mat(mp.type)
        # the hitpoint: the first smooth vertex (glossy lobes of any width;
        # the gather evaluates them)
        frame = Frame.from_normal(ns)
        wi_local = frame.to_local(-d)
        rec = act & ~is_delta & ~hp_valid
        hp_pos = torch.where(rec[..., None], p, hp_pos)
        hp_ns = torch.where(rec[..., None], ns, hp_ns)
        hp_alb = torch.where(rec[..., None], bsdf_mod.albedo_p(mp), hp_alb)
        hp_T = torch.where(rec[..., None], T, hp_T)
        hp_mid = torch.where(rec, mid, hp_mid)
        hp_wol = torch.where(rec[..., None], wi_local, hp_wol)
        hp_valid = hp_valid | rec

        # continue through delta materials only
        bs = bsdf_mod.sample_p(mp, wi_local, u[..., 3:6], types=mat_types)
        wo_world = frame.to_world(bs.wo)
        cont = act & is_delta & (torch.amax(torch.abs(bs.weight), dim=-1) > 0.0)
        T = torch.where(cont[..., None], T * bs.weight, T)
        o = torch.where(cont[..., None], _offset_ray(p, ng, wo_world), o)
        d = torch.where(cont[..., None], wo_world, d)
        alive = cont
    return Hitpoints(hp_pos, hp_ns, hp_alb, hp_T, hp_valid, L, hp_mid, hp_wol)


def photon_pass(scene: SceneData, rkeys, max_depth: int = 5, accel: str = "auto",
                em_kinds=em_mod.PORTED_KINDS, mat_types=bsdf_mod.PORTED_TYPES):
    """One wave of photons, one a key.  Returns the deposits of every
    bounce flattened (depth-major): (pos (D M, 3), wi (D M, 3) the
    incident direction, power (D M, 3), ok (D M,), caustic (D M,)), a
    caustic deposit reached through one or more all-specular bounces (the
    caustic map's membership)."""
    geo = scene.geo
    intersect, _ = route_dense_or_bvh(scene, accel)
    rs = em_mod.sample_ray(scene.emitters, scene.aabb_min, scene.aabb_max,
                           event_uniform(rkeys, TAG_EMITTER_RAY, 5), kinds=em_kinds)
    o, d = rs.o, rs.d
    T = torch.where(rs.valid[..., None], rs.weight, 0.0)
    alive = rs.valid
    all_spec = torch.ones_like(rs.valid)
    outs = []
    for depth in range(max_depth):
        u = bounce_uniform(rkeys, depth, 9)
        hit = intersect(o, d, torch.where(alive, INFD, -1.0))
        act = alive & hit.valid
        p, ng, ns, row, _ = _decode_hit(geo, hit, o, d)
        mp = bsdf_mod.gather_params(scene.mats, row[18].to(torch.int32), types=mat_types)
        # deposit on smooth surfaces
        deposit = act & ~_is_delta_mat(mp.type)
        outs.append((p, -d, T, deposit, all_spec & (depth > 0)))

        frame = Frame.from_normal(ns)
        bs = bsdf_mod.sample_p(mp, frame.to_local(-d), u[..., 3:6], types=mat_types)
        wo_world = frame.to_world(bs.wo)
        T_new = T * bs.weight
        # roulette keeps the photons' powers bounded
        q = torch.clamp(torch.amax(bs.weight, dim=-1), 0.05, 0.95)
        rr = u[..., 8] < q
        T_new = T_new / torch.clamp_min(q, 1e-6)[..., None]
        cont = act & rr & (bs.pdf > 0.0) & (torch.amax(torch.abs(T_new), dim=-1) > 0.0)
        o = torch.where(cont[..., None], _offset_ray(p, ng, wo_world), o)
        d = torch.where(cont[..., None], wo_world, d)
        T = torch.where(cont[..., None], T_new, T)
        alive = cont
        all_spec = all_spec & bs.is_delta
    pos, wi, pw, ok, caus = (torch.cat(x) for x in zip(*outs))
    return pos, wi, pw, ok, caus


def _cell_coords(p, lo, inv_cell: float, G: int):
    c = torch.floor((p - lo) * inv_cell).to(torch.int32)
    return torch.clamp(c, 0, G - 1)


def _cell_key(c, G: int):
    return (c[..., 0] * G + c[..., 1]) * G + c[..., 2]


class SortedPhotons(NamedTuple):
    """Photons in a random order, then sorted by cell key (stable)."""

    keys: torch.Tensor  # (M,) int32, NO_CELL for a photon not deposited
    pos: torch.Tensor   # (M, 3)
    dir: torch.Tensor   # (M, 3)
    pw: torch.Tensor    # (M, 3)


def sort_photons(ph_pos, ph_dir, ph_pw, ph_ok, lo, inv_cell: float, G: int,
                 seed: int = PHOTON_ORDER_SEED) -> SortedPhotons:
    """The grid's photon order: a random permutation (``seed``'s key), so
    that a depth's deposits do not come first in a cell, then a stable
    sort by cell key."""
    keys = torch.where(ph_ok, _cell_key(_cell_coords(ph_pos, lo, inv_cell, G), G), NO_CELL)
    perm = rng.permutation(rng.base_key(seed, device=keys.device), keys.shape[0])
    keys = keys[perm]
    skeys, order = torch.sort(keys, stable=True)
    idx = perm[order]
    return SortedPhotons(skeys, ph_pos[idx], ph_dir[idx], ph_pw[idx])


def cell_segments(sp: SortedPhotons, x, lo, inv_cell: float, G: int):
    """The 2 x 2 x 2 cells about each point's nearest cell corner: for
    each, (start, end) of its photons in the sorted order, a cell seen
    before (two offsets clipped onto one cell at the grid's border) empty."""
    base = torch.floor((x - lo) * inv_cell - 0.5).to(torch.int32)
    seen = []
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                c = torch.stack([base[..., 0] + ox, base[..., 1] + oy, base[..., 2] + oz], -1)
                key = _cell_key(torch.clamp(c, 0, G - 1), G)
                dup = torch.zeros(key.shape, dtype=torch.bool, device=x.device)
                for prev in seen:
                    dup = dup | (key == prev)
                seen.append(key)
                key = torch.where(dup, -1, key)
                yield (torch.searchsorted(sp.keys, key, side="left"),
                       torch.searchsorted(sp.keys, key, side="right"))


def _repeat_lanes(p, k: int):
    """Gathered material parameters with each lane repeated k times (the
    coat row keeps its lanes on axis 1)."""
    def rep(name, x):
        if x is None or not (torch.is_tensor(x) or isinstance(x, tuple)):
            return x
        if isinstance(x, tuple):
            return tuple(_repeat_lanes(y, k) if hasattr(y, "_fields") else rep(name, y)
                         for y in x)
        return x.repeat_interleave(k, dim=1 if name == "tcoat" else 0)

    return type(p)(*(rep(f, getattr(p, f)) for f in p._fields))


def cell_taps(sp: SortedPhotons, start, end, taps):
    """A cell's first taps for each point: (photon index (N, T), in the
    cell (N, T), the cell's reweight count / T (N,))."""
    at = start[:, None] + taps[None, :]
    m_total = sp.keys.shape[0]
    scale = torch.clamp_min((end - start).to(torch.float32) / taps.shape[0], 1.0)
    return (torch.clamp_max(at, m_total - 1), (at < end[:, None]) & (at < m_total), scale)


def gather_sorted(sp: SortedPhotons, hp_pos, hp_ns, hp_R, lo, inv_cell: float, G: int,
                  hp_p=None, hp_wol=None, narrow_types=()):
    """The per-hitpoint gather on sorted photons: (count (N,), flux binned
    by incident direction (N, K, 3), the per-photon f-weighted flux (N, 3)
    for the ``narrow_types`` families, ``hp_p`` being the hitpoints'
    gathered material parameters and ``hp_wol`` the camera direction in
    their frames).  A cell's taps are evaluated at once and added in the
    reference's order, tap by tap."""
    n_hp, dev = hp_pos.shape[0], hp_pos.device
    n_taps = MAX_CELL_TAPS
    taps = torch.arange(n_taps, device=dev)
    count = torch.zeros((n_hp,), dtype=torch.float32, device=dev)
    phi = torch.zeros((n_hp, N_DIR_BINS, 3), dtype=torch.float32, device=dev)
    phi_pp = torch.zeros((n_hp, 3), dtype=torch.float32, device=dev)
    fr = Frame.from_normal(hp_ns)
    fr = Frame(s=fr.s[:, None], t=fr.t[:, None], n=fr.n[:, None])
    ns = hp_ns[:, None, :]
    if narrow_types:
        wi2_pp, s_pp = bsdf_mod._flip_two_sided(hp_p, hp_wol)
        p_rep = _repeat_lanes(hp_p, n_taps)
        wi2_rep = wi2_pp.repeat_interleave(n_taps, dim=0)
    r2 = (hp_R * hp_R)[:, None]
    for start, end in cell_segments(sp, hp_pos, lo, inv_cell, G):
        # a dense cell: its first taps, reweighted by count / taps (the
        # random order makes the first taps a fair sample)
        idx, okk, scale = cell_taps(sp, start, end, taps)
        ph_pos, ph_wi, ph_pw = sp.pos[idx], sp.dir[idx], sp.pw[idx]   # (N, T, 3)
        dp = ph_pos - hp_pos[:, None, :]
        d2 = torch.sum(dp * dp, dim=-1)
        front = dot(ns, ph_wi) > 0.0
        # a disc: photons off the tangent plane stay out
        planar = torch.abs(dot(dp, ns)) <= 0.1 * hp_R[:, None]
        sel = okk & (d2 <= r2) & front & planar
        cnt = torch.where(sel, scale[:, None], 0.0)
        # the incident direction's bin in the hitpoint frame
        wil = fr.to_local(ph_wi)
        band = torch.clamp((wil[..., 2] * N_COS_BANDS).to(torch.int32), 0, N_COS_BANDS - 1)
        az = torch.atan2(wil[..., 1], wil[..., 0])
        sector = torch.clamp(((az / (2.0 * math.pi) + 0.5) * N_AZIMUTH).to(torch.int32), 0,
                             N_AZIMUTH - 1)
        b = (band * N_AZIMUTH + sector).to(torch.int64)[..., None].expand(n_hp, n_taps, 3)
        contrib = torch.where(sel[..., None], ph_pw * scale[:, None, None], 0.0)
        if narrow_types:
            # per-photon eval: f(camera, photon); eval gives f cos(wo), and
            # the photon's cosine is divided back out (the flux carries the
            # arrival geometry)
            wo2 = torch.stack([wil[..., 0], wil[..., 1], wil[..., 2] * s_pp[:, None]], dim=-1)
            f_pp, _ = bsdf_mod._eval_smooth(p_rep, wi2_rep, wo2.reshape(-1, 3), narrow_types)
            f_pp = f_pp.reshape(n_hp, n_taps, 3) / torch.clamp_min(
                torch.abs(wil[..., 2]), 1e-3)[..., None]
            pp = torch.where(sel[..., None], f_pp * ph_pw * scale[:, None, None], 0.0)
        for j in range(n_taps):
            count = count + cnt[:, j]
            # one photon a hitpoint: each (hitpoint, bin) takes one add
            phi.scatter_add_(1, b[:, j:j + 1], contrib[:, j:j + 1])
            if narrow_types:
                phi_pp = phi_pp + pp[:, j]
    return count, phi, phi_pp


def gather(hp_pos, hp_ns, hp_R, ph_pos, ph_wi, ph_pw, ph_ok, lo, inv_cell: float, G: int,
           hp_p=None, hp_wol=None, narrow_types=()):
    """``gather_sorted`` on photons sorted anew (``sort_photons``)."""
    sp = sort_photons(ph_pos, ph_wi, ph_pw, ph_ok, lo, inv_cell, G)
    return gather_sorted(sp, hp_pos, hp_ns, hp_R, lo, inv_cell, G, hp_p, hp_wol, narrow_types)


def grid_params(scene: SceneData, cell: float):
    """(lo, 1 / cell, G): the grid over the scene's box with cells of
    ``cell``, at most GRID_MAX an axis (a host read of the box)."""
    extent = float(torch.amax(scene.aabb_max - scene.aabb_min))
    G = min(int(np.ceil(extent / cell)) + 1, GRID_MAX)
    return scene.aabb_min, 1.0 / cell, G


def scene_extent(scene: SceneData) -> float:
    return float(torch.amax(scene.aabb_max - scene.aabb_min))


def render_sppm(scene: SceneData, cfg, n_iterations: int = 8, photons_per_iter: int = 1 << 17,
                alpha: float = 0.7, r_init: float | None = None):
    """Full SPPM render; returns (H, W, 3) on the scene's device."""
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present

    dev = resolve_device(scene.geo.p0.device)
    w, h = cfg.width, cfg.height
    n_pix = w * h
    em_kinds = kinds_present(scene.emitters)
    mat_types = types_present(scene.mats)
    kw = dict(accel=cfg.accel, em_kinds=em_kinds, mat_types=mat_types)
    if r_init is None:
        r_init = 2.5 * scene_extent(scene) / max(w, h)
    lo, inv_cell, G = grid_params(scene, 2.0 * r_init)
    narrow_types = tuple(t for t in PER_PHOTON_FAMILIES if t in mat_types)
    centers = torch.from_numpy(_dir_bin_centers()).to(dev)

    f32 = dict(dtype=torch.float32, device=dev)
    N_stat = torch.zeros((n_pix,), **f32)
    R_stat = torch.full((n_pix,), r_init, **f32)
    tau = torch.zeros((n_pix, 3), **f32)
    L_direct = torch.zeros((n_pix, 3), **f32)
    key = rng.base_key(cfg.seed, device=dev)
    pix = torch.arange(n_pix, dtype=torch.int32, device=dev)
    ph_ids = torch.arange(photons_per_iter, dtype=torch.int32, device=dev) + (1 << 24)

    for it in range(n_iterations):
        rk_cam = rng.ray_keys(key, pix, torch.full_like(pix, it))
        hp = camera_pass(scene, rk_cam, w, h, event_uniform(rk_cam, 1 << 20, 2), pix,
                         max_depth=cfg.max_depth, sensor_kind=int(scene.sensor.kind), **kw)
        L_direct = L_direct + hp.L

        rk_ph = rng.ray_keys(key, ph_ids, torch.full_like(ph_ids, it))
        ph_pos, ph_wi, ph_pw, ph_ok, _ = photon_pass(scene, rk_ph, max_depth=cfg.max_depth, **kw)
        hp_p = bsdf_mod.gather_params(scene.mats, hp.mid, types=mat_types)
        M_new, phi, phi_pp = gather(hp.pos, hp.ns, R_stat, ph_pos, ph_wi, ph_pw, ph_ok, lo,
                                    inv_cell, G, hp_p=hp_p, hp_wol=hp.wol,
                                    narrow_types=narrow_types)
        M_new = torch.where(hp.valid, M_new, 0.0)
        # the full BSDF: one smooth-lobe evaluation a bin against the camera
        # direction, on the binned flux (eval gives f cos(wo): the bin
        # centre's cosine is divided back out)
        phi_f = torch.zeros((n_pix, 3), **f32)
        for k in range(N_DIR_BINS):
            fk, _ = bsdf_mod.eval_pdf_p(hp_p, hp.wol, centers[k].expand(n_pix, 3),
                                        types=mat_types)
            phi_f = phi_f + fk / centers[k, 2] * phi[:, k, :]
        if narrow_types:
            use_pp = torch.zeros_like(hp.valid)
            for t in narrow_types:
                use_pp = use_pp | (hp_p.type == t)
            phi_f = torch.where(use_pp[..., None], phi_pp, phi_f)
        phi = torch.where(hp.valid[..., None], hp.T * phi_f / photons_per_iter, 0.0)
        # the Hachisuka-Jensen update
        N_new = N_stat + alpha * M_new
        denom = torch.clamp_min(N_stat + M_new, 1e-8)
        ratio = torch.where(M_new > 0, N_new / denom, 1.0)
        R_stat = R_stat * torch.sqrt(ratio)
        tau = (tau + phi) * ratio[..., None]
        # N_stat is not carried to the next pass, as in the reference: every
        # pass that finds photons scales R^2 and tau by alpha (ROADMAP
        # Queue 3)

    L_ind = tau / (math.pi * (R_stat * R_stat)[..., None] * n_iterations)
    return (L_direct / n_iterations + L_ind).reshape(h, w, 3)
