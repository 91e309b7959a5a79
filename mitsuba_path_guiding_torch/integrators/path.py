"""Wavefront unidirectional path tracer with NEE, MIS and Russian
roulette (port of the reference's integrators/path.py ``trace``).

The bounce loop is a Python loop over a fixed depth of SoA ray tensors
with alive masks; every stage {intersect, emitter eval, NEE, BSDF or
guided sampling, RR} runs on the whole wavefront.  Per hit, the shading
row and the emitter row are fetched through ``ops.gather.gather_rows_t``
and the material row once per bounce through ``bsdf.gather_params``
(reused by NEE evaluation, sampling and the albedo AOV).  Intersection
follows the reference's routing with the card in the TPU's place
(``trace``'s docstring): pair route, Morton-sorted blocklist, BVH,
tiled kernel or dense oracle.

When NULL or MASK is among the scene's types, shadow rays march through
transparent surfaces (``accel.traverse.shadow_transmittance`` with the
wave's own closest-hit query), and a straight pass-through keeps the MIS
state of the last real vertex while its distance accumulates.

Explicit ``uniforms`` (9 * max_depth, N), dim-major, replace the
counter-based draws bounce by bounce: the hook of the Sobol' bounce
dimensions (``RenderConfig.qmc_bounces``) and of primary-sample-space
mutations.

Textures (``textured``), bump and normal maps (``bumped``) and cloth
(``clothed``) read the UV tiling, the texture ids and the wireframe's
fields from the bounce's material-row gather, and with vertex colours
gather the (T, 9) colour table too; the atlas itself is indexed per lane
(``models/texture.py``).  ``cone_angle`` > 0 filters the reflectance
texture trilinearly between mip levels by a ray-cone footprint.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from mitsuba_path_guiding_torch.accel.traverse import (
    intersect_brute,
    intersect_bvh,
    intersect_pairs_full,
    intersect_pallas,
    intersect_twolevel,
    occluded_brute,
    occluded_pairs_full,
    occluded_pallas,
    occluded_twolevel,
    shadow_transmittance,
    tri_pack_rows,
)
from mitsuba_path_guiding_torch.accel.traverse import occluded as occluded_bvh
from mitsuba_path_guiding_torch.core.math import Frame, dot, normalize, power_heuristic
from mitsuba_path_guiding_torch.core.rng import bounce_uniform
from mitsuba_path_guiding_torch.core.spectrum import luminance
from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod
from mitsuba_path_guiding_torch.models import emitter as em_mod
from mitsuba_path_guiding_torch.models.cloth import decode_record
from mitsuba_path_guiding_torch.models.texture import sample_atlas, sample_atlas_nearest
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t
from mitsuba_path_guiding_torch.scene.types import BSDFType, SceneData
from mitsuba_path_guiding_torch.utils.stats import span

INFD = 3.0e37

# Pair-route constants, the reference's defaults: pair compaction budget
# (cap*N + dummies sorted pairs run) and the tile engine ("mt" or "plk").
PAIR_CAP = 5
PAIR_ENGINE = "mt"
# The reference's pair-route configurations (its measurement knobs, read at
# call time).  (ksb, l_blk) list widths of the camera wave, taken at depth 0
# when PAIR_PEEL is on, and of every other query; the fallback shifts of
# each: None re-traces every unproven ray, an int n the reference's cap of
# max(4096, N >> n) rays.  The reference's shifts are 4, a cap that leaves
# rays with a farther hit than the true one (door_room() got brighter);
# the port departs from it by default (ROADMAP.md Queue 3).
# SHADOW_BLOCKLIST sends the shadow rays of a scene with pair tables to the
# Morton-sorted blocklist (``occluded_twolevel``) instead of the pairs.
CAM_PAIR_CFG = (12, 12)
SCAN_PAIR_CFG = (8, 8)
PAIR_PEEL = False
CAM_FB_SHIFT = None
SCAN_FB_SHIFT = None
SHADOW_BLOCKLIST = False
# route_dense_or_bvh's "auto" takes the dense tiled intersector up to this
# many triangles and the BVH above, as the reference routes its volumetric
# and light-path integrators
BRUTE_FORCE_MAX_TRIS = 16384


class PathAux(NamedTuple):
    """First-hit feature buffers."""

    albedo: torch.Tensor     # (N, 3)
    normal: torch.Tensor     # (N, 3)
    depth_t: torch.Tensor    # (N,)
    n_bounces: torch.Tensor  # (N,) int32 realised path length
    first_le: torch.Tensor   # (N, 3) emission seen at the first hit


class PathRecord(NamedTuple):
    """Per-bounce records for guiding-cache training, component-major
    (D, 3, N) for vectors, as in the reference."""

    pos: torch.Tensor    # (D, 3, N)
    dir: torch.Tensor    # (D, 3, N)
    li: torch.Tensor     # (D, N)
    pdf: torch.Tensor    # (D, N)
    valid: torch.Tensor  # (D, N) bool
    dist: torch.Tensor = None  # (D, N)


def _offset_ray(p, ng, d):
    """Offset origin along the geometric normal toward the ray side."""
    s = torch.sign(dot(ng, d))[..., None]
    return p + ng * s * 1e-4


def _check_supported(scene, accel, uniforms, max_depth, n):
    if accel not in ("auto", "pallas", "brute", "bvh", "twolevel"):
        raise ValueError(f"unknown accel '{accel}'")
    if accel == "twolevel" and scene.blocks is None:
        raise ValueError("accel='twolevel' needs block tables (16384 triangles or more)")
    if uniforms is not None and tuple(uniforms.shape) != (9 * max_depth, n):
        raise ValueError(f"uniforms must be (9 * max_depth, N) = {(9 * max_depth, n)}, "
                         f"got {tuple(uniforms.shape)}")


def _surface_textures(scene, row, mrow, hit, prim, ns, ng, dist, prev_delta, textured, bumped,
                      clothed, cone_angle):
    """The texture lookups at a wave's hits: (shading normal, reflectance
    override (rgb, mask) or None, cloth record or None).  ``row`` and
    ``mrow`` are the hits' shading and material rows (32, N); the
    material row gives the UV tiling (25:27), the texture ids (14; 19,
    the bump slot) and the wireframe's colours and width (21:25)."""
    b0 = 1.0 - hit.u - hit.v
    uv = torch.stack([
        (b0 * row[12] + hit.u * row[14] + hit.v * row[16]) * mrow[25],
        (b0 * row[13] + hit.u * row[15] + hit.v * row[17]) * mrow[26],
    ], dim=-1)
    atlas, sizes = scene.textures, scene.texture_sizes
    tex = cloth_aux = None
    if textured:
        tid = mrow[14].to(torch.int32)
        lod = None
        if cone_angle > 0.0:
            # ray-cone footprint: distance x cone x (UV per world unit) x
            # texels per UV; diffuse and glossy scatters widen the cone
            cone_eff = torch.where(prev_delta, cone_angle, 0.15)
            t_id = torch.clamp_min(tid, 0).long()
            res = torch.maximum(sizes[t_id, 0], sizes[t_id, 1])
            lod = torch.log2(torch.clamp_min(dist * cone_eff * row[26] * res, 1.0))
        val = sample_atlas(atlas, sizes, tid, uv, lod=lod)
        if scene.geo.vcol is not None:
            # the interpolated vertex colours (curvature maps are baked to
            # vertex colours at build time)
            vrow = gather_rows_t(scene.geo.vcol, prim)  # (9, N)
            vc = torch.stack([b0 * vrow[k] + hit.u * vrow[k + 3] + hit.v * vrow[k + 6]
                              for k in range(3)], dim=-1)
            val = torch.where((tid == -3)[..., None], vc, val)
        # wireframe: a barycentric edge distance under the line width takes
        # the edge colour
        edge = torch.minimum(torch.minimum(b0, hit.u), hit.v) < mrow[24]
        wire_val = torch.where(edge[..., None], mrow[21:24].T, mrow[1:4].T)
        val = torch.where((tid == -4)[..., None], wire_val, val)
        tex = (val, (tid >= 0) | (tid <= -3))
    btid = mrow[19].to(torch.int32)
    if clothed:
        # a CLOTH row's bump slot holds its yarn-record map: one nearest
        # fetch gives the lane's record for the band-gated integrand
        cloth_aux = decode_record(sample_atlas_nearest(atlas, sizes, btid, uv))
    if bumped:
        # the normal map perturbs the shading frame (height maps became
        # normal maps at build time); a CLOTH row's bump slot is data
        n_t = sample_atlas(atlas, sizes, btid, uv) * 2.0 - 1.0
        ns_b = normalize(Frame.from_normal(ns).to_world(normalize(n_t)))
        ns_b = torch.where(dot(ns_b, ng)[..., None] < 0.0, -ns_b, ns_b)
        apply_b = btid >= 0
        if clothed:
            apply_b = apply_b & (mrow[0] != float(int(BSDFType.CLOTH)))
        ns = torch.where(apply_b[..., None], ns_b, ns)
    return ns, tex, cloth_aux


def _blocks_route(scene: SceneData, accel: str) -> bool:
    return accel == "twolevel" or (accel == "auto" and scene.blocks is not None)


def pair_route(scene: SceneData, accel: str) -> bool:
    """Whether ``route_queries`` takes the pair route."""
    return _blocks_route(scene, accel) and scene.pairs is not None


def route_queries(scene: SceneData, accel: str, use_bvh: bool = False):
    """The (intersect, occluded) queries of one route, each taking
    (o, d, tmax); ``trace``'s docstring gives the routing.  On the pair
    route ``intersect`` also takes ``pair_cfg`` = (ksb, l_blk, fb_shift),
    by default SCAN_PAIR_CFG + (SCAN_FB_SHIFT,); shadows take that too, or
    the sorted blocklist with SHADOW_BLOCKLIST."""
    geo = scene.geo
    blocks_route = _blocks_route(scene, accel)
    if pair_route(scene, accel):
        def intersect(o, d, tmax, pair_cfg=None):
            ksb, l_blk, fb = pair_cfg or SCAN_PAIR_CFG + (SCAN_FB_SHIFT,)
            return intersect_pairs_full(scene.pairs, scene.blocks, o, d, tmax, ksb=ksb,
                                        l_blk=l_blk, fb_shift=fb, cap_factor=PAIR_CAP,
                                        engine=PAIR_ENGINE)

        def occluded(o, d, tmax):
            if SHADOW_BLOCKLIST:
                return occluded_twolevel(scene.blocks, o, d, tmax)
            return occluded_pairs_full(scene.pairs, scene.blocks, o, d, tmax,
                                       ksb=SCAN_PAIR_CFG[0], l_blk=SCAN_PAIR_CFG[1],
                                       fb_shift=SCAN_FB_SHIFT, cap_factor=PAIR_CAP,
                                       engine=PAIR_ENGINE)
    elif blocks_route:
        def intersect(o, d, tmax):
            return intersect_twolevel(scene.blocks, o, d, tmax)

        def occluded(o, d, tmax):
            return occluded_twolevel(scene.blocks, o, d, tmax)
    elif accel == "bvh" or (accel == "auto" and use_bvh):
        def intersect(o, d, tmax):
            return intersect_bvh(geo, scene.bvh, o, d, tmax)

        def occluded(o, d, tmax):
            return occluded_bvh(geo, scene.bvh, o, d, tmax)
    elif accel == "brute":
        def intersect(o, d, tmax):
            return intersect_brute(geo, o, d, tmax)

        def occluded(o, d, tmax):
            return occluded_brute(geo, o, d, tmax)
    else:
        pack = tri_pack_rows(geo)

        def intersect(o, d, tmax):
            return intersect_pallas(geo, o, d, tmax, pack=pack)

        def occluded(o, d, tmax):
            return occluded_pallas(geo, o, d, tmax, pack=pack)
    return intersect, occluded


def resolve_use_bvh(scene: SceneData, cfg) -> bool:
    """A RenderConfig's ``use_bvh``, or when None whether the scene has
    more than BRUTE_FORCE_MAX_TRIS triangles (the reference's rule).  The
    routes take it as ``trace``'s ``use_bvh``: a scene with block tables
    keeps its block route, and a non-"auto" ``accel`` wins."""
    if cfg.use_bvh is not None:
        return bool(cfg.use_bvh)
    return int(scene.geo.p0.shape[0]) > BRUTE_FORCE_MAX_TRIS


def dense_or_bvh_accel(scene: SceneData, accel: str = "auto", use_bvh: bool = False) -> str:
    """The route named for ``route_queries`` by ``route_dense_or_bvh``:
    "auto" becomes "pallas" at BRUTE_FORCE_MAX_TRIS triangles or fewer and
    "bvh" above them or with ``use_bvh``; any other ``accel`` stays."""
    if accel == "auto":
        big = use_bvh or scene.geo.p0.shape[0] > BRUTE_FORCE_MAX_TRIS
        return "bvh" if big else "pallas"
    return accel


def route_dense_or_bvh(scene: SceneData, accel: str = "auto", use_bvh: bool = False):
    """``route_queries`` of the integrators that the reference routes to
    its dense oracle or its BVH (the volumetric tracer, the light-path,
    Markov-chain and photon-map integrators, the auxiliary ones): "auto"
    takes the tiled kernel at BRUTE_FORCE_MAX_TRIS triangles or fewer and
    the BVH above them or with ``use_bvh``; any other ``accel`` goes to
    ``route_queries`` as named.  The tiled kernel has the dense oracle's
    winner."""
    return route_queries(scene, dense_or_bvh_accel(scene, accel, use_bvh))


def trace(
    scene: SceneData,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    rkeys: torch.Tensor,
    max_depth: int = 5,
    rr_depth: int = 5,
    use_nee: bool = True,
    use_bvh: bool = False,
    guide=None,
    guide_state=None,
    record_paths: bool = False,
    em_kinds=em_mod.PORTED_KINDS,
    mat_types=bsdf_mod.PORTED_TYPES,
    textured: bool = False,
    bumped: bool = False,
    clothed: bool = False,
    uniforms=None,
    accel: str = "auto",
    cone_angle: float = 0.0,
):
    """Trace one wavefront to completion.

    Returns (L (N, 3), PathAux, PathRecord | None).  Every closest-hit and
    shadow query of the wave takes one route, the reference's with the
    card in the TPU's place (its kernels on the card, their plain versions
    on the CPU):
    - "auto" or "twolevel" on a scene with block tables (16384 triangles
      or more): the pair route if it has pair tables, else the blocklist
      on Morton-sorted rays ("twolevel" raises without block tables); on
      the pair route depth 0 takes CAM_PAIR_CFG and CAM_FB_SHIFT when
      PAIR_PEEL is on and ``max_depth`` > 1, every other closest hit
      SCAN_PAIR_CFG and SCAN_FB_SHIFT (``route_queries``);
    - "bvh", or "auto" on a smaller scene with ``use_bvh``: the BVH, for
      shadows too;
    - "pallas", or "auto" otherwise: the tiled intersector;
    - "brute": the dense oracle.
    Shadow rays through NULL and MASK surfaces march with the route's
    closest-hit query.

    ``textured``, ``bumped`` and ``clothed`` (host reads of the scene:
    ``integrators.render`` ``_textured``, ``_has_bump``, ``_has_cloth``)
    turn on the reflectance override, the normal-map frame and the cloth's
    yarn records; ``cone_angle`` > 0 the mip filtering."""
    n = ray_o.shape[0]
    _check_supported(scene, accel, uniforms, max_depth, n)
    bsdf_mod.check_types(mat_types)
    dev = ray_o.device
    with span("trace", device=dev):
        geo, mats, em = scene.geo, scene.mats, scene.emitters
        intersect, occluded = route_queries(scene, accel, use_bvh)
        # the camera peel: depth 0, the one coherent wave, with its own widths
        peel = PAIR_PEEL and pair_route(scene, accel) and max_depth > 1

        # null and mask surfaces transmit shadow rays; boolean occlusion where
        # the scene has no transparent material
        transparent = BSDFType.NULL in mat_types or BSDFType.MASK in mat_types
        if transparent:
            def visibility(o_, d_, tmax_):
                return shadow_transmittance(geo, mats.packed, o_, d_, tmax_, intersect)
        else:
            def visibility(o_, d_, tmax_):
                return 1.0 - occluded(o_, d_, tmax_).to(torch.float32)

        f32 = dict(dtype=torch.float32, device=dev)
        o, d = ray_o, ray_d
        L = torch.zeros((n, 3), **f32)
        T = torch.ones((n, 3), **f32)
        alive = torch.ones((n,), dtype=torch.bool, device=dev)
        prev_pdf = torch.full((n,), INFD, **f32)
        prev_delta = torch.ones((n,), dtype=torch.bool, device=dev)
        t_acc = torch.zeros((n,), **f32)  # distance through straight pass-throughs
        aux = PathAux(
            albedo=torch.zeros((n, 3), **f32),
            normal=torch.zeros((n, 3), **f32),
            depth_t=torch.zeros((n,), **f32),
            n_bounces=torch.zeros((n,), dtype=torch.int32, device=dev),
            first_le=torch.zeros((n, 3), **f32),
        )
        recs = []

        # uniforms per bounce: 0:3 NEE, 3:6 BSDF (2 dir + lobe),
        # 6 guide selection, 7 guide lobe, 8 russian roulette
        for depth in range(max_depth):
            if uniforms is None:
                with span("keys", depth=depth):
                    u = bounce_uniform(rkeys, depth, 9)
            else:
                u = uniforms[depth * 9:(depth + 1) * 9].T
            with span("intersect", depth=depth):
                tmax = torch.where(alive, INFD, -1.0)
                if peel and depth == 0:
                    hit = intersect(o, d, tmax, pair_cfg=CAM_PAIR_CFG + (CAM_FB_SHIFT,))
                else:
                    hit = intersect(o, d, tmax)
                escaped = alive & ~hit.valid

                env_L = em_mod.eval_env(em, d, kinds=em_kinds)
                if use_nee:
                    pdf_nee_env = em_mod.pdf_env(em, d, kinds=em_kinds)
                    w_env = torch.where(
                        prev_delta, 1.0,
                        power_heuristic(prev_pdf,
                                        torch.broadcast_to(pdf_nee_env, prev_pdf.shape)))
                else:
                    w_env = torch.ones_like(prev_pdf)
                L = torch.where(escaped[..., None], L + T * env_L * w_env[..., None], L)

            with span("shade", depth=depth):
                act = alive & hit.valid
                prim = torch.clamp_min(hit.prim, 0)
                t_hit = torch.where(hit.valid, hit.t, 1.0)
                p = o + t_hit[..., None] * d
                row = gather_rows_t(geo.shade_packed, prim)  # (32, N)
                ng = torch.stack([row[0], row[1], row[2]], dim=-1)
                b0 = 1.0 - hit.u - hit.v
                ns = normalize(torch.stack(
                    [
                        b0 * row[3] + hit.u * row[6] + hit.v * row[9],
                        b0 * row[4] + hit.u * row[7] + hit.v * row[10],
                        b0 * row[5] + hit.u * row[8] + hit.v * row[11],
                    ],
                    dim=-1,
                ))
                ns = torch.where(dot(ns, ng)[..., None] < 0.0, -ns, ns)
                mid = row[18].to(torch.int32)
                is_emitter = row[19] >= 0.0
                tex = cloth_aux = mrow = None
                if textured or bumped or clothed:
                    # the material-row gather of gather_params, made here: it
                    # also serves the textures' fields
                    mrow = gather_rows_t(mats.packed, mid)  # (32, N)
                    ns, tex, cloth_aux = _surface_textures(
                        scene, row, mrow, hit, prim, ns, ng, t_hit + t_acc, prev_delta,
                        textured, bumped, clothed, cone_angle)
                mp_raw = bsdf_mod.gather_params(mats, mid, types=mat_types, row=mrow)
                mp = bsdf_mod.apply_texture(mp_raw, tex, cloth_aux)

                # emissive hit with MIS against NEE
                cos_l = dot(ng, -d)
                Le = torch.where((is_emitter & (cos_l > 0.0))[..., None],
                                 torch.stack([row[20], row[21], row[22]], dim=-1), 0.0)
                if use_nee:
                    # the distance through straight pass-throughs keeps NEE's MIS
                    # consistent across them
                    d_mis = t_hit + t_acc
                    dist2 = d_mis * d_mis
                    pdf_nee_hit = row[23] * dist2 / torch.clamp_min(
                        torch.abs(cos_l) * torch.clamp_min(row[25], 1e-12), 1e-12)
                    pdf_nee_hit = torch.where(is_emitter, pdf_nee_hit, 0.0)
                    w_hit = torch.where(prev_delta, 1.0, power_heuristic(prev_pdf, pdf_nee_hit))
                else:
                    w_hit = torch.ones_like(prev_pdf)
                L = torch.where(act[..., None], L + T * Le * w_hit[..., None], L)

                frame = Frame.from_normal(ns)
                wi_local = frame.to_local(-d)

                first = act & (aux.depth_t == 0.0)
                aux = PathAux(
                    albedo=torch.where(first[..., None], bsdf_mod.albedo_p(mp_raw), aux.albedo),
                    normal=torch.where(first[..., None], ns, aux.normal),
                    depth_t=torch.where(first, hit.t, aux.depth_t),
                    n_bounces=aux.n_bounces + act.to(torch.int32),
                    first_le=torch.where(first[..., None], Le, aux.first_le),
                )

            # next-event estimation
            if use_nee:
                with span("nee", depth=depth):
                    ds = em_mod.sample_direct(em, geo, p, u[..., 0:3], kinds=em_kinds)
                    wo_local_nee = frame.to_local(ds.direction)
                    f_nee, pdf_bsdf_nee = bsdf_mod.eval_pdf_p(mp, wi_local, wo_local_nee,
                                                              types=mat_types)
                    if guide is not None:
                        pdf_dir_nee = guide.pdf_at(guide_state, mats, mid, p, frame,
                                                   ds.direction, pdf_bsdf_nee, params=mp)
                    else:
                        pdf_dir_nee = pdf_bsdf_nee
                    o_sh = _offset_ray(p, ng, ds.direction)
                    t_sh = torch.where(ds.distance >= INFD, INFD, ds.distance * (1.0 - 1e-3))
                    vis = visibility(o_sh, ds.direction, torch.where(act, t_sh, -1.0))
                    w_mis = torch.where(ds.is_delta, 1.0, power_heuristic(ds.pdf, pdf_dir_nee))
                    contrib = (T * f_nee * ds.radiance
                               * (vis * w_mis / torch.clamp_min(ds.pdf, 1e-12))[..., None])
                    good = act & (vis > 0.0) & (ds.pdf > 0.0)
                    L = torch.where(good[..., None], L + contrib, L)

            with span("sample", depth=depth):
                # BSDF (or guided) sampling
                if guide is None:
                    bs = bsdf_mod.sample_p(mp, wi_local, u[..., 3:6], types=mat_types)
                    wo_world = frame.to_world(bs.wo)
                    next_pdf, next_weight, next_delta = bs.pdf, bs.weight, bs.is_delta
                else:
                    wo_world, next_pdf, next_weight, next_delta = guide(
                        guide_state, mats, mid, p, frame, wi_local, u[..., 3:6],
                        u[..., 6], u[..., 7], tex, cloth_aux, params=mp)

                T_new = T * next_weight
                cont = act & (torch.amax(torch.abs(T_new), dim=-1) > 0.0) & (next_pdf > 0.0)

                # russian roulette
                if depth >= rr_depth:
                    q = torch.clamp(torch.amax(T_new, dim=-1), 0.05, 0.95)
                    T_new = torch.where(cont[..., None],
                                        T_new / torch.clamp_min(q, 1e-6)[..., None], T_new)
                    cont = cont & (u[..., 8] < q)

                # a straight pass-through (null or mask transmission) keeps the MIS
                # state of the last real vertex and accumulates its distance; else a
                # light behind the surface would get delta weight 1 and full NEE
                if transparent:
                    straight = next_delta & (dot(wo_world, d) > 1.0 - 1e-6)
                    next_pdf_c = torch.where(straight, prev_pdf, next_pdf)
                    next_delta_c = torch.where(straight, prev_delta, next_delta)
                    t_acc_new = torch.where(straight, t_acc + t_hit, 0.0)
                else:
                    next_pdf_c, next_delta_c = next_pdf, next_delta
                    t_acc_new = torch.zeros_like(t_acc)

                o_next = _offset_ray(p, ng, wo_world)
                if record_paths:
                    recs.append((
                        p.T, wo_world.T, luminance(L),
                        luminance(torch.where(cont[..., None], T_new, T)),
                        next_pdf, act & ~next_delta,
                        torch.where(hit.valid, t_hit, INFD),
                    ))
                o = torch.where(cont[..., None], o_next, o)
                d = torch.where(cont[..., None], wo_world, d)
                T = torch.where(cont[..., None], T_new, T)
                prev_pdf = torch.where(cont, next_pdf_c, prev_pdf)
                prev_delta = torch.where(cont, next_delta_c, prev_delta)
                t_acc = torch.where(cont, t_acc_new, t_acc)
                alive = cont

        record = None
        if record_paths:
            rec_pos, rec_dir, rec_lumL, rec_lumT, rec_pdf, rec_valid, rec_t = (
                torch.stack(x, dim=0) for x in zip(*recs))
            lum_final = luminance(L)[None, :]
            li = torch.clamp_min(lum_final - rec_lumL, 0.0) / torch.clamp_min(rec_lumT, 1e-6)
            rec_dist = torch.cat([rec_t[1:], torch.full_like(rec_t[:1], INFD)], dim=0)
            record = PathRecord(pos=rec_pos, dir=rec_dir, li=li, pdf=rec_pdf,
                                valid=rec_valid, dist=rec_dist)
        return L, aux, record
