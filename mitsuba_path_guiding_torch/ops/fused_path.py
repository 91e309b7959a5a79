"""Fused path-tracing megakernel for small diffuse scenes.

Port of ``mitsuba_path_guiding_tpu/ops/fused_path.py`` (``fused_supported``,
``build_fused_tables``, ``_pack_guide``, ``trace_fused``).  The whole bounce
loop of one ray per lane runs in one kernel: 13-round threefry uniforms on
the (depth, block) counters under the per-ray key, the Pluecker closest-hit
test with its packed-key winner and an exact Moeller-Trumbore
re-evaluation of the winner, emissive MIS, NEE with an any-hit shadow ray,
the diffuse BSDF, optional one-sample MIS with the K=8 vMF mixture read
from a bf16 guide table, and Russian roulette.

On a CUDA tensor ``trace_fused`` launches ``csrc/fused_path.cu`` (one
thread per ray, scalar FP32 code, triangle and emitter tables in shared
memory; see the note there).  On a CPU tensor it runs ``trace_fused_plain``,
the same arithmetic in the same order vectorised over lanes.

The random stream is not the wavefront path's ``jax.random`` stream: the
reference kernel hashes (depth, block) counters directly (its
fused_path.py:30-34), and so do both versions here.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from mitsuba_path_guiding_torch.core.rng import bits_to_unit, threefry2x32
from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.scene.types import BSDFType, EmitterKind, SceneData
from mitsuba_path_guiding_torch.utils.stats import host_read

EPS_T = 1e-4
INFD = 3.0e37
INF = float("inf")
GUIDE_CHUNK = 2048
OUT_ROWS = 16
K_LOBES = 8
PLK_COLS = 25   # packed Pluecker coefficients per triangle (kernel layout)
MAX_TRIS = 2048
MAX_EMITTERS = 32
PI = math.pi
INV_FOURPI = float(np.float32(1.0 / (4.0 * np.pi)))

_FN: dict = {}


# ---------------------------------------------------------------------------
# host-side tables
# ---------------------------------------------------------------------------

def _pack_plk_rows(p0, e1, e2, t_pad):
    """(t_pad, 25) packed Pluecker coefficients, one row per triangle: for
    each edge (v0->v1, v1->v2, v2->v0) a x b and b - a, then the plane
    (-n, n.v0) and n.  The numbers of the reference's ``_pack_tri_cols``,
    laid out for one triangle's loads to be contiguous."""
    t = p0.shape[0]
    v0, v1, v2 = p0, p0 + e1, p0 + e2
    nvec = np.cross(e1, e2)
    rows = np.zeros((t_pad, PLK_COLS), np.float32)
    for g, (a, b) in enumerate(((v0, v1), (v1, v2), (v2, v0))):
        rows[:t, 6 * g: 6 * g + 3] = np.cross(a, b)
        rows[:t, 6 * g + 3: 6 * g + 6] = b - a
    rows[:t, 18:21] = -nvec
    rows[:t, 21] = (nvec * v0).sum(-1)
    rows[:t, 22:25] = nvec
    return rows


def _host(x, what="tables"):
    """A scene table read to the host for the kernel's tables or its gate."""
    return host_read(x, "fused_path." + what).numpy()


def _pack_shade_rows(scene: SceneData, t_pad):
    """(t_pad, 32): 0:9 p0/e1/e2, 9:12 gn, 12:21 n0/n1/n2, 21 mid,
    22 emitter flag (-1 on pad rows), 23:26 emission, 26 pmf, 27 area."""
    sp = _host(scene.geo.shade_packed)
    t = sp.shape[0]
    out = np.zeros((t_pad, 32), np.float32)
    out[:t, 0:3] = _host(scene.geo.p0)
    out[:t, 3:6] = _host(scene.geo.e1)
    out[:t, 6:9] = _host(scene.geo.e2)
    out[:t, 9:12] = sp[:, 0:3]
    out[:t, 12:21] = sp[:, 3:12]
    out[:t, 21] = sp[:, 18]
    out[:t, 22] = sp[:, 19]
    out[t:, 22] = -1.0
    out[:t, 23:26] = sp[:, 20:23]
    out[:t, 26] = sp[:, 23]
    out[:t, 27] = sp[:, 25]
    return out


def fused_supported(scene: SceneData) -> bool:
    """Host-side gate: diffuse materials without a texture, a bump map or
    vertex colours, area emitters, no medium, at most 2048 triangles and
    32 emitters.  The kernel shades with the material row's reflectance
    alone, so a textured scene takes the wavefront (the reference's gate
    checks the material types only: on a TPU it would drop the texture)."""
    if scene.medium is not None and bool(scene.medium.enabled):
        return False
    if set(_host(scene.mats.type, "supported").tolist()) - {int(BSDFType.DIFFUSE)}:
        return False
    if scene.geo.vcol is not None or bool(_host((scene.mats.texture_id != -1).any(),
                                                "supported")):
        return False
    if bool(_host((scene.mats.packed[:, 19] >= 0).any(), "supported")):
        return False
    if set(_host(scene.emitters.kind, "supported").tolist()) - {int(EmitterKind.AREA)}:
        return False
    if scene.geo.p0.shape[0] > MAX_TRIS:
        return False
    if scene.emitters.kind.shape[0] > MAX_EMITTERS:
        return False
    return True


class FusedTables(NamedTuple):
    """Scene constants of the fused kernel, one row per triangle, emitter
    or material (the CUDA kernel and the plain version read the same
    tensors)."""

    plk_rows: torch.Tensor    # (t_pad, 25) Pluecker coefficients
    shade_rows: torch.Tensor  # (t_pad, 32) shading rows
    em_rows: torch.Tensor     # (e_pad, 32) Emitters.packed, column 31 the CDF
    mat_rows: torch.Tensor    # (m_pad, 8): type, reflectance
    n_tri: int
    n_em: int
    n_mat: int


def build_fused_tables(scene: SceneData) -> FusedTables:
    """Pack the scene into the kernel's tables (host-side)."""
    dev = scene.geo.p0.device
    n_tri = int(scene.geo.p0.shape[0])
    t_pad = max(((n_tri + 7) // 8) * 8, 8)
    n_em = int(scene.emitters.kind.shape[0])
    e_pad = 8 * ((n_em + 7) // 8)
    n_mat = int(scene.mats.type.shape[0])
    m_pad = 8 * ((n_mat + 7) // 8)
    plk = _pack_plk_rows(_host(scene.geo.p0), _host(scene.geo.e1), _host(scene.geo.e2), t_pad)
    shade = _pack_shade_rows(scene, t_pad)
    em = np.zeros((e_pad, 32), np.float32)
    em[:n_em] = _host(scene.emitters.packed)
    em[:n_em, 31] = _host(scene.emitters.cdf)
    em[n_em:, 31] = 2.0  # beyond any u: pad rows are never picked
    mat = np.zeros((m_pad, 8), np.float32)
    mat[:n_mat, 0] = _host(scene.mats.type).astype(np.float32)
    mat[:n_mat, 1:4] = _host(scene.mats.reflectance)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return FusedTables(t(plk), t(shade), t(em), t(mat), n_tri, n_em, n_mat)


def _pack_guide(grid):
    """(cpad, 48) bf16 guide table, cell-major (columns: 8 mu_x, 8 mu_y,
    8 mu_z, 8 kappa, 8 log-weights, valid, alpha_scale; every value rounded
    to bf16 as the reference's ``_pack_guide`` rounds it) and the (8,)
    float32 meta [aabb_min, res / extent, res, 0]."""
    c, k = grid.kappa.shape
    if k != K_LOBES:
        raise ValueError("the fused kernel is compiled for K=8 lobes")
    dev = grid.mu.device
    a_col = grid.alpha_scale if grid.alpha_scale is not None else torch.ones((c,), device=dev)
    packed = torch.cat(
        [grid.mu[..., 0], grid.mu[..., 1], grid.mu[..., 2], grid.kappa, grid.log_weight,
         grid.valid[:, None].to(torch.float32), a_col[:, None].to(torch.float32)], dim=1,
    ).to(torch.bfloat16)
    cpad = ((c + GUIDE_CHUNK - 1) // GUIDE_CHUNK) * GUIDE_CHUNK
    guide_tab = torch.zeros((cpad, 48), dtype=torch.bfloat16, device=dev)
    guide_tab[:c, :42] = packed
    res = torch.round(torch.tensor(float(c), dtype=torch.float32) ** (1.0 / 3.0)).to(dev)
    extent = torch.clamp_min(grid.aabb_max - grid.aabb_min, 1e-6)
    sc = torch.div(res.expand(3), extent)
    meta = torch.cat([grid.aabb_min.to(torch.float32), sc.to(torch.float32), res[None],
                      torch.zeros((1,), device=dev)])
    return guide_tab, meta


# the grid packed by the last guided call and its tables: the frozen-cache
# loop passes one grid to every wave, so it is packed once
_GUIDE_CACHE: list = [None, None]


def _guide_for(grid):
    if _GUIDE_CACHE[0] is not grid:
        _GUIDE_CACHE[:] = [grid, _pack_guide(grid)]
    return _GUIDE_CACHE[1]


# ---------------------------------------------------------------------------
# the plain version: the kernel's arithmetic vectorised over lanes
# ---------------------------------------------------------------------------

def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _normalize3(v):
    inv = torch.rsqrt(torch.clamp_min(_dot3(v, v), 1e-30))
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _where3(c, a, b):
    return tuple(torch.where(c, x, y) for x, y in zip(a, b))


def _scale3(v, s):
    return (v[0] * s, v[1] * s, v[2] * s)


def _add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _mul3(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _frame(n):
    """Duff et al. branchless ONB."""
    sign = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[2])
    b = n[0] * n[1] * a
    s = (1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0])
    t = (b, sign + n[1] * n[1] * a, -n[1])
    return s, t, n


def _to_local(s, t, n, v):
    return (_dot3(v, s), _dot3(v, t), _dot3(v, n))


def _to_world(s, t, n, v):
    return (v[0] * s[0] + v[1] * t[0] + v[2] * n[0],
            v[0] * s[1] + v[1] * t[1] + v[2] * n[1],
            v[0] * s[2] + v[1] * t[2] + v[2] * n[2])


def _power_heuristic(pa, pb):
    a2 = pa * pa
    w = a2 / torch.clamp_min(a2 + pb * pb, 1e-30)
    return torch.where(pa > 0.0, w, 0.0)


def _cosine_hemisphere(u0, u1):
    x = 2.0 * u0 - 1.0
    y = 2.0 * u1 - 1.0
    zero = (x == 0.0) & (y == 0.0)
    use_x = torch.abs(x) > torch.abs(y)
    r = torch.where(use_x, x, y)

    def sdiv(a, b):
        return a / torch.where(torch.abs(b) < 1e-12, 1.0, b)

    phi = torch.where(use_x, (PI / 4.0) * sdiv(y, x), (PI / 2.0) - (PI / 4.0) * sdiv(x, y))
    r = torch.where(zero, 0.0, r)
    phi = torch.where(zero, 0.0, phi)
    px = r * torch.cos(phi)
    py = r * torch.sin(phi)
    return px, py, torch.sqrt(torch.clamp_min(1.0 - px * px - py * py, 0.0))


def _vmf_pdf(t, kappa):
    """Exp-normalised vMF pdf with 1 - exp (the reference kernel's form)."""
    kk = torch.clamp(kappa, 0.0, 1e4)
    denom = 2.0 * PI * (1.0 - torch.exp(-2.0 * kk))
    norm = torch.where(kk > 1e-6, kk / torch.clamp_min(denom, 1e-30), INV_FOURPI)
    return norm * torch.exp(kk * (torch.clamp(t, -1.0, 1.0) - 1.0))


def _intersect_plain(plk_rows, o, d, tmax, n_tri, any_hit):
    """Pluecker test of every (lane, triangle) pair, summed in the
    kernel's order.  Closest: (prim, valid) by the packed-key winner.
    Any-hit: (occluded, triangles tested), where a lane stops testing at
    its first occluder, as the kernel does."""
    t_pad = plk_rows.shape[0]
    m = _cross3(o, d)
    col = lambda j: plk_rows[:, j][None, :]  # noqa: E731
    lane = [x[:, None] for x in (d[0], d[1], d[2], m[0], m[1], m[2], o[0], o[1], o[2])]

    def side(g):
        acc = col(6 * g) * lane[0] + col(6 * g + 1) * lane[1]
        for j in range(2, 6):
            acc = acc + col(6 * g + j) * lane[j]
        return acc

    s0, s1, s2 = side(0), side(1), side(2)
    num = col(18) * lane[6] + col(19) * lane[7] + col(20) * lane[8] + col(21)
    den = col(22) * lane[0] + col(23) * lane[1] + col(24) * lane[2]
    smin = torch.minimum(torch.minimum(s0, s1), s2)
    smax = torch.maximum(torch.maximum(s0, s1), s2)
    if any_hit:
        inside = (smin >= 0.0) | (smax <= 0.0)
    else:
        eps = 1e-6 * (torch.abs(s0) + torch.abs(s1) + torch.abs(s2))
        inside = (smin >= -eps) | (smax <= eps)
    ok_den = den != 0.0
    t = num / torch.where(ok_den, den, 1.0)
    tid = torch.arange(t_pad, dtype=torch.int32, device=o[0].device)[None, :]
    hit = inside & ok_den & (t > EPS_T) & (t < tmax[:, None]) & (tid < n_tri)
    if any_hit:
        occ = torch.any(hit, dim=1)
        first = torch.argmax(hit.to(torch.int8), dim=1)   # the first occluder's id
        return occ, torch.where(occ, first + 1, n_tri)
    t = torch.where(hit, t, INF)
    lo_mask = (1 << max((t_pad - 1).bit_length(), 1)) - 1
    key = (t.view(torch.int32) & ~lo_mask) | tid
    key_best = torch.min(key, dim=1).values
    t_best = (key_best & ~lo_mask).view(torch.float32)
    valid = t_best < INF
    return torch.where(valid, key_best & lo_mask, -1), valid


def _mt_exact(tri, o, d):
    p0, e1, e2 = (tri[0], tri[1], tri[2]), (tri[3], tri[4], tri[5]), (tri[6], tri[7], tri[8])
    pvec = _cross3(d, e2)
    det = _dot3(e1, pvec)
    inv = 1.0 / torch.where(torch.abs(det) < 1e-20, 1.0, det)
    tvec = _sub3(o, p0)
    u = _dot3(tvec, pvec) * inv
    qvec = _cross3(tvec, e1)
    v = _dot3(d, qvec) * inv
    t = _dot3(e2, qvec) * inv
    return t, u, v


def _ksum(x):
    """Sum over the lobe axis in the kernel's order (k = 0, 1, ...)."""
    acc = x[0]
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    return acc


def trace_fused_plain(tables: FusedTables, ray_o, ray_d, rkeys, guide_tab=None, meta=None,
                      max_depth: int = 5, rr_depth: int = 5, guided: bool = False,
                      alpha: float = 0.5):
    """The fused kernel's arithmetic on whole lanes; returns the (16, N)
    output rows: 0:3 L, 3:6 first-hit albedo, 6:9 first-hit normal, 9 depth,
    10 bounces, 11:14 first-hit emission, and two work counts, 14 the
    closest-hit loops entered and 15 the triangles the shadow rays tested.
    ``rkeys`` (N, 2) int64 uint32 words; ``guide_tab`` and ``meta`` from
    ``_pack_guide`` when ``guided``."""
    n = ray_o.shape[0]
    dev = ray_o.device
    f32 = dict(dtype=torch.float32, device=dev)
    n_tri, n_em, n_mat = tables.n_tri, tables.n_em, tables.n_mat
    o = (ray_o[:, 0], ray_o[:, 1], ray_o[:, 2])
    d = (ray_d[:, 0], ray_d[:, 1], ray_d[:, 2])
    k0, k1 = rkeys[:, 0], rkeys[:, 1]
    zero = torch.zeros((n,), **f32)
    L = (zero,) * 3
    T = (torch.ones((n,), **f32),) * 3
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.full((n,), INFD, **f32)
    prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
    a_alb, a_nrm, a_fle = (zero,) * 3, (zero,) * 3, (zero,) * 3
    a_dep, a_nb, a_it, a_sh = zero, zero, zero, zero
    if guided:
        g_lo, g_sc, g_res = meta[0:3], meta[3:6], meta[6]
        gtab = guide_tab[:, :42].to(torch.float32)

    for depth in range(max_depth):
        u = []
        for blk in range(5):
            b0, b1 = threefry2x32(k0, k1, depth, blk, rounds=13)
            u.append(bits_to_unit(b0))
            u.append(bits_to_unit(b1))

        a_it = a_it + alive.to(torch.float32)
        tmax = torch.where(alive, INFD, -1.0)
        prim, valid = _intersect_plain(tables.plk_rows, o, d, tmax, n_tri, False)
        act = alive & valid
        srow = tables.shade_rows[torch.clamp_min(prim, 0)].T
        t_ex, hu, hv = _mt_exact(srow[0:9], o, d)
        t_hit = torch.where(valid, torch.clamp_min(t_ex, EPS_T), 1.0)
        p = _add3(o, _scale3(d, t_hit))
        ng = (srow[9], srow[10], srow[11])
        b0c = 1.0 - hu - hv
        ns = _normalize3((b0c * srow[12] + hu * srow[15] + hv * srow[18],
                          b0c * srow[13] + hu * srow[16] + hv * srow[19],
                          b0c * srow[14] + hu * srow[17] + hv * srow[20]))
        ns = _where3(_dot3(ns, ng) < 0.0, _scale3(ns, -1.0), ns)
        mid = srow[21].to(torch.int64)
        is_em = srow[22] >= 0.0
        le = (srow[23], srow[24], srow[25])

        cos_l = _dot3(ng, _scale3(d, -1.0))
        emit = is_em & (cos_l > 0.0)
        pdf_nee_hit = srow[26] * (t_hit * t_hit) / torch.clamp_min(
            torch.abs(cos_l) * torch.clamp_min(srow[27], 1e-12), 1e-12)
        pdf_nee_hit = torch.where(is_em, pdf_nee_hit, 0.0)
        w_hit = torch.where(prev_delta, 1.0, _power_heuristic(prev_pdf, pdf_nee_hit))
        gain = torch.where(act & emit, w_hit, 0.0)
        L = _add3(L, _mul3(T, _scale3(le, gain)))

        mrow = tables.mat_rows[torch.clamp(mid, 0, n_mat - 1)].T
        refl = (mrow[1], mrow[2], mrow[3])
        first = act & (a_dep == 0.0)
        a_alb = _where3(first, refl, a_alb)
        a_nrm = _where3(first, ns, a_nrm)
        a_dep = torch.where(first, t_hit, a_dep)
        a_nb = a_nb + act.to(torch.float32)
        a_fle = _where3(first, _scale3(le, emit.to(torch.float32)), a_fle)

        fs, ft, fn = _frame(ns)
        wi_l = _to_local(fs, ft, fn, _scale3(d, -1.0))

        if guided:
            q = [torch.clamp((p[i] - g_lo[i]) * g_sc[i], 0.0, None) for i in range(3)]
            q = [torch.minimum(x, g_res - 1.0) for x in q]
            res_i = g_res.to(torch.int64)
            cid = (q[0].to(torch.int64) * res_i + q[1].to(torch.int64)) * res_i + q[2].to(torch.int64)
            grow = gtab[cid].T
            gmx, gmy, gmz = grow[0:8], grow[8:16], grow[16:24]
            gkap, glogw = grow[24:32], grow[32:40]
            gvalid = grow[40] > 0.5
            g_ascale = grow[41]
            wmax = torch.amax(glogw, dim=0, keepdim=True)
            we = torch.exp(glogw - wmax)
            gw = we / torch.clamp_min(_ksum(we), 1e-30)[None]

            def mix_pdf(dv):
                t = gmx * dv[0][None] + gmy * dv[1][None] + gmz * dv[2][None]
                return torch.where(gvalid, _ksum(gw * _vmf_pdf(t, gkap)), INV_FOURPI)

            a_g = torch.where(gvalid, float(np.float32(alpha)) * g_ascale, 0.0)

        # NEE: CDF emitter pick (pad rows carry cdf 2.0), a uniform point
        # on the emitting triangle, diffuse eval, any-hit shadow ray
        cdf_row = tables.em_rows[:, 31]
        eid = torch.sum((cdf_row[:, None] <= u[0][None, :]).to(torch.int64), dim=0)
        erow = tables.em_rows[torch.clamp(eid, 0, n_em - 1)].T
        su = torch.sqrt(torch.clamp_min(u[1], 0.0))
        tb0 = 1.0 - su
        tb1 = u[2] * su
        qp = (erow[14] + tb0 * erow[17] + tb1 * erow[20],
              erow[15] + tb0 * erow[18] + tb1 * erow[21],
              erow[16] + tb0 * erow[19] + tb1 * erow[22])
        eng = (erow[23], erow[24], erow[25])
        to_q = _sub3(qp, p)
        nee_d2 = torch.clamp_min(_dot3(to_q, to_q), 1e-12)
        nee_dist = torch.sqrt(nee_d2)
        nee_dir = _scale3(to_q, 1.0 / nee_dist)
        cos_e = _dot3(eng, _scale3(nee_dir, -1.0))
        nee_pdf = erow[1] * nee_d2 / torch.clamp_min(
            torch.abs(cos_e) * torch.clamp_min(erow[13], 1e-12), 1e-12)
        nee_rad = _scale3((erow[2], erow[3], erow[4]), (cos_e > 0.0).to(torch.float32))
        wo_nee_l = _to_local(fs, ft, fn, nee_dir)
        up_nee = (wi_l[2] > 0.0) & (wo_nee_l[2] > 0.0)
        cos_nee = torch.where(up_nee, torch.clamp_min(wo_nee_l[2], 0.0) / PI, 0.0)
        f_nee = _scale3(refl, cos_nee)
        pdf_dir_nee = a_g * mix_pdf(nee_dir) + (1.0 - a_g) * cos_nee if guided else cos_nee
        off = torch.where(_dot3(ng, nee_dir) >= 0.0, 1e-4, -1e-4)
        o_sh = _add3(p, _scale3(ng, off))
        t_sh = torch.where(act, nee_dist * (1.0 - 1e-3), -1.0)
        occ, n_tested = _intersect_plain(tables.plk_rows, o_sh, nee_dir, t_sh, n_tri, True)
        a_sh = a_sh + torch.where(act, n_tested, 0).to(torch.float32)
        vis = 1.0 - occ.to(torch.float32)
        gain_nee = vis * _power_heuristic(nee_pdf, pdf_dir_nee) / torch.clamp_min(nee_pdf, 1e-12)
        good = act & (vis > 0.0) & (nee_pdf > 0.0)
        gain_nee = torch.where(good, gain_nee, 0.0)
        L = _add3(L, _mul3(T, _mul3(f_nee, _scale3(nee_rad, gain_nee))))

        # BSDF or guided direction
        wo_cos = _cosine_hemisphere(u[3], u[4])
        pdf_cos = torch.clamp_min(wo_cos[2], 0.0) / PI
        if guided:
            run = torch.zeros_like(gw[0])
            ksel = torch.zeros_like(eid)
            for kk_i in range(K_LOBES):
                run = run + gw[kk_i]
                ksel = ksel + (u[7] > run).to(torch.int64)
            ksel = torch.clamp(ksel, 0, K_LOBES - 1)[None, :]
            mu_k = (gmx.gather(0, ksel)[0], gmy.gather(0, ksel)[0], gmz.gather(0, ksel)[0])
            kk = torch.clamp(gkap.gather(0, ksel)[0], 0.0, 1e4)
            u0c = torch.clamp(u[3], 1e-7, 1.0 - 1e-7)
            safe_k = torch.clamp_min(kk, 1e-3)
            wz = 1.0 + torch.log(u0c + (1.0 - u0c) * torch.exp(-2.0 * safe_k)) / safe_k
            wz = torch.where(kk > 1e-3, wz, 1.0 - 2.0 * u0c)
            wz = torch.clamp(wz, -1.0, 1.0)
            rr_ = torch.sqrt(torch.clamp_min(1.0 - wz * wz, 0.0))
            phi_v = 2.0 * PI * u[4]
            vloc = (rr_ * torch.cos(phi_v), rr_ * torch.sin(phi_v), wz)
            ms, mt_, mn = _frame(_normalize3(mu_k))
            d_vmf = _to_world(ms, mt_, mn, vloc)
            zu = 1.0 - 2.0 * u[3]
            ru = torch.sqrt(torch.clamp_min(1.0 - zu * zu, 0.0))
            d_uni = (ru * torch.cos(phi_v), ru * torch.sin(phi_v), zu)
            d_guided = _where3(gvalid, d_vmf, d_uni)
            wo_g_l = _to_local(fs, ft, fn, d_guided)
            wo_l = _where3(u[6] < a_g, wo_g_l, wo_cos)
            wo_w = _to_world(fs, ft, fn, wo_l)
            up = (wi_l[2] > 0.0) & (wo_l[2] > 0.0)
            f_sel = torch.where(up, torch.clamp_min(wo_l[2], 0.0) / PI, 0.0)
            pdf_comb = a_g * mix_pdf(wo_w) + (1.0 - a_g) * f_sel
            wsc = torch.where(pdf_comb > 1e-9, f_sel / torch.clamp_min(pdf_comb, 1e-8), 0.0)
            native = a_g <= 0.0
            next_w = _where3(native, refl, _scale3(refl, wsc))
            next_pdf = torch.where(native, pdf_cos, pdf_comb)
        else:
            wo_w = _to_world(fs, ft, fn, wo_cos)
            next_w = refl
            next_pdf = pdf_cos

        T_new = _mul3(T, next_w)
        tmax_t = torch.maximum(torch.maximum(torch.abs(T_new[0]), torch.abs(T_new[1])),
                               torch.abs(T_new[2]))
        cont = act & (tmax_t > 0.0) & (next_pdf > 0.0)
        if rr_depth < max_depth and depth >= rr_depth:
            qrr = torch.clamp(torch.maximum(torch.maximum(T_new[0], T_new[1]), T_new[2]), 0.05, 0.95)
            T_new = _where3(cont, _scale3(T_new, 1.0 / torch.clamp_min(qrr, 1e-6)), T_new)
            cont = cont & (u[8] < qrr)

        offn = torch.where(_dot3(ng, wo_w) >= 0.0, 1e-4, -1e-4)
        o = _where3(cont, _add3(p, _scale3(ng, offn)), o)
        d = _where3(cont, wo_w, d)
        T = _where3(cont, T_new, T)
        prev_pdf = torch.where(cont, next_pdf, prev_pdf)
        prev_delta = prev_delta & ~cont
        alive = cont

    return torch.stack([*L, *a_alb, *a_nrm, a_dep, a_nb, *a_fle, a_it, a_sh], dim=0)


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper and the entry point
# ---------------------------------------------------------------------------

def _kernel_fn():
    f = _FN.get("trace_fused")
    if f is None:
        f = build.load("fused_path").trace_fused_launch
        c_p, c_i, c_f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        f.argtypes = [c_p, c_p, c_p, c_i,            # o, d, keys, N
                      c_p, c_p, c_i, c_i, c_i,       # plk, shade, n_tri, t_pad, lo_mask
                      c_p, c_i, c_i, c_p, c_i,       # em, n_em, e_pad, mat, n_mat
                      c_p, c_p, c_i, c_f,            # guide, meta, guided, alpha
                      c_i, c_i, c_p, c_p]            # max_depth, rr_depth, out, stream
        f.restype = ctypes.c_int
        _FN["trace_fused"] = f
    return f


def keys_as_int32(rkeys: torch.Tensor) -> torch.Tensor:
    """(N, 2) uint32 words held in int64 -> the same bit patterns as int32
    (values >= 2^31 wrap explicitly, not by a value cast)."""
    k = rkeys.to(torch.int64) & 0xFFFFFFFF
    return torch.where(k >= 2**31, k - 2**32, k).to(torch.int32).contiguous()


def trace_fused_cuda(tables: FusedTables, ray_o, ray_d, rkeys, guide_tab=None, meta=None,
                     max_depth: int = 5, rr_depth: int = 5, guided: bool = False,
                     alpha: float = 0.5):
    """Launch the CUDA kernel; returns the (16, N) output rows."""
    build.refuse_grad("trace_fused", tables.plk_rows, tables.shade_rows, tables.em_rows,
                      tables.mat_rows, ray_o, ray_d, guide_tab, meta)
    if not (ray_o.is_cuda and ray_d.is_cuda and rkeys.is_cuda and tables.plk_rows.is_cuda):
        raise ValueError("trace_fused: rays, keys and tables must be on the card")
    n = ray_o.shape[0]
    o = ray_o.to(torch.float32).contiguous()
    d = ray_d.to(torch.float32).contiguous()
    if o.shape != (n, 3) or d.shape != (n, 3) or rkeys.shape != (n, 2):
        raise ValueError("trace_fused: rays must be (N, 3) and keys (N, 2)")
    keys = keys_as_int32(rkeys)
    out = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=o.device)
    t_pad = tables.shade_rows.shape[0]
    lo_mask = (1 << max((t_pad - 1).bit_length(), 1)) - 1
    if guided:
        if guide_tab.dtype != torch.bfloat16 or guide_tab.dim() != 2 or guide_tab.shape[1] != 48:
            raise ValueError("trace_fused: the guide table must be (cpad, 48) bf16")
        guide_tab = guide_tab.contiguous()
        meta = meta.to(torch.float32).contiguous()
        g_ptr, m_ptr = build.ptr(guide_tab), build.ptr(meta)
    else:
        g_ptr = m_ptr = ctypes.c_void_p(0)
    build.check(_kernel_fn()(
        build.ptr(o), build.ptr(d), build.ptr(keys), n,
        build.ptr(tables.plk_rows), build.ptr(tables.shade_rows), tables.n_tri, t_pad, lo_mask,
        build.ptr(tables.em_rows), tables.n_em, tables.em_rows.shape[0],
        build.ptr(tables.mat_rows), tables.n_mat,
        g_ptr, m_ptr, int(guided), float(alpha),
        int(max_depth), int(rr_depth), build.ptr(out), build.stream_ptr(o.device),
    ), "trace_fused")
    build.LAUNCHES["trace_fused"] += 1
    return out


def trace_fused(tables: FusedTables, ray_o, ray_d, rkeys, grid=None, max_depth: int = 5,
                rr_depth: int = 5, guided: bool = False, alpha: float = 0.5):
    """Fused trace with the contract of integrators.path.trace for the
    supported scene class: returns (L (N, 3), PathAux, None).  ``grid``: a
    level-0 GuidingGrid when ``guided``."""
    from mitsuba_path_guiding_torch.integrators.path import PathAux

    guide_tab = meta = None
    if guided:
        if grid is None:
            raise ValueError("trace_fused: guided=True needs a grid")
        guide_tab, meta = _guide_for(grid)
    run = trace_fused_cuda if ray_o.is_cuda else trace_fused_plain
    out = run(tables, ray_o, ray_d, rkeys, guide_tab, meta, max_depth=max_depth,
              rr_depth=rr_depth, guided=guided, alpha=alpha)
    aux = PathAux(
        albedo=out[3:6].T,
        normal=out[6:9].T,
        depth_t=out[9],
        n_bounces=out[10].to(torch.int32),
        first_le=out[11:14].T,
    )
    return out[0:3].T, aux, None
