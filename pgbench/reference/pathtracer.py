"""The plain reference path tracer of a diffuse scene with area lights:
pinhole camera rays with a uniform jitter in the pixel (box filter),
closest hits and shadow rays by testing every triangle, two-sided
Lambertian reflection sampled by the cosine, next-event estimation on a
triangle of the lights picked by area and a uniform point on it,
emission from the front face alone (the side the winding's normal
faces), both strategies weighted by the power heuristic, and paths of at
most ``max_depth`` segments with a light connection from each of their
vertices.  Rays leave a surface 1e-4 along its normal, and shadow rays
stop 0.1% short of the light.  It renders passes of one sample a pixel
and returns the mean of each block of pixels, and the closest-hit
queries that its paths asked, a path's mean: the work that a scene's
paths need, which a kernel's roofline counts.  Plain torch, with its
own random numbers (torch.Generator); it imports nothing of the program."""
import math

import torch

EPS_T = 1e-4
OFFSET = 1e-4


def _closest(tri, o, d, live):
    """(t, prim, hit) over all triangles, (N,)."""
    p0, e1, e2 = tri
    pv = torch.linalg.cross(d[:, None, :].expand(-1, e2.shape[0], -1),
                            e2[None].expand(d.shape[0], -1, -1))
    det = (e1[None] * pv).sum(-1)
    ok = det.abs() >= 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    tv = o[:, None, :] - p0[None]
    u = (tv * pv).sum(-1) * inv
    qv = torch.linalg.cross(tv, e1[None].expand_as(tv))
    v = (d[:, None, :] * qv).sum(-1) * inv
    t = (e2[None] * qv).sum(-1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > EPS_T) & live[:, None]
    return t, hit


def _first(tri, o, d, live):
    t, hit = _closest(tri, o, d, live)
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    tmin, prim = t.min(dim=1)
    return tmin, prim, hit.any(dim=1)


def _blocked(tri, o, d, tmax, live):
    t, hit = _closest(tri, o, d, live)
    return (hit & (t < tmax[:, None])).any(dim=1)


def _power(a, b):
    return torch.where(a > 0, a * a / torch.clamp_min(a * a + b * b, 1e-30), torch.zeros_like(a))


def _frame(n):
    """Two unit tangents of unit normals n (Duff et al.)."""
    s = torch.where(n[:, 2] >= 0, torch.ones_like(n[:, 2]), -torch.ones_like(n[:, 2]))
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t1 = torch.stack([1 + s * n[:, 0] ** 2 * a, s * b, -s * n[:, 0]], -1)
    t2 = torch.stack([b, s + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return t1, t2


def trace(sc, o, d, max_depth, gen, dtype):
    """Radiance (N, 3) of camera rays o, d, and the closest-hit queries
    asked (a 0-d tensor): one a segment, the camera's and an escaping
    segment's included."""
    dev = o.device
    tri = (sc["p0"], sc["e1"], sc["e2"])
    n = o.shape[0]
    L = torch.zeros((n, 3), dtype=dtype, device=dev)
    T = torch.ones((n, 3), dtype=dtype, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    prev_pdf = torch.full((n,), float("inf"), dtype=dtype, device=dev)
    first = True
    em_idx, em_cdf, em_pmf = sc["em_idx"], sc["em_cdf"], sc["em_pmf"]

    def rnd(k):
        return torch.rand((n, k), generator=gen, device=dev).to(dtype)

    queries = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        queries += alive.sum()
        t, prim, hit = _first(tri, o, d, alive)
        hit = hit & alive
        t = torch.where(hit, t, torch.ones_like(t))
        p = o + t[:, None] * d
        ng = sc["ng"][prim]
        cos_l = -(ng * d).sum(-1)
        le = torch.where((cos_l > 0)[:, None], sc["emission"][prim], torch.zeros_like(L))
        if first:
            w_hit = torch.ones_like(t)
        else:
            pdf_l = sc["tri_pmf"][prim] * t * t / torch.clamp_min(cos_l.abs() * sc["area"][prim],
                                                                1e-12)
            w_hit = _power(prev_pdf, pdf_l)
        L = L + torch.where(hit[:, None], T * le * w_hit[:, None], torch.zeros_like(L))

        # the shading side: the normal turned towards the incoming ray
        side = torch.where((ng * d).sum(-1) < 0, torch.ones_like(t), -torch.ones_like(t))
        ns = ng * side[:, None]
        refl = sc["refl"][prim]

        # next-event estimation
        u_pick = torch.rand(n, generator=gen, device=dev)
        pick = torch.clamp(torch.searchsorted(em_cdf, u_pick, right=True), max=len(em_idx) - 1)
        u = rnd(2)
        lt = em_idx[pick]
        su = torch.sqrt(u[:, 0])
        b0, b1 = 1 - su, u[:, 1] * su
        q = sc["p0"][lt] + b0[:, None] * sc["e1"][lt] + b1[:, None] * sc["e2"][lt]
        to_q = q - p
        dist = torch.sqrt(torch.clamp_min((to_q * to_q).sum(-1), 1e-12))
        wl = to_q / dist[:, None]
        cos_light = -(sc["ng"][lt] * wl).sum(-1)
        pdf_nee = em_pmf[pick] * dist * dist / torch.clamp_min(cos_light.abs() * sc["area"][lt], 1e-12)
        cos_o = (ns * wl).sum(-1)
        o_sh = p + sc["ng"][prim] * torch.sign((ng * wl).sum(-1))[:, None] * OFFSET
        ok = hit & (cos_o > 0) & (cos_light > 0)
        blocked = _blocked(tri, o_sh, wl, dist * (1 - 1e-3), ok)
        pdf_b = cos_o / math.pi
        contrib = (T * refl * (cos_o / math.pi)[:, None] * sc["emission"][lt]
                   * (_power(pdf_nee, pdf_b) / torch.clamp_min(pdf_nee, 1e-12))[:, None])
        L = L + torch.where((ok & ~blocked)[:, None], contrib, torch.zeros_like(L))

        # cosine-weighted continuation on the shading side
        u = rnd(2)
        r, phi = torch.sqrt(u[:, 0]), 2 * math.pi * u[:, 1]
        z = torch.sqrt(torch.clamp_min(1 - u[:, 0], 0))
        t1, t2 = _frame(ns)
        wo = (r * torch.cos(phi))[:, None] * t1 + (r * torch.sin(phi))[:, None] * t2 + z[:, None] * ns
        T = T * refl
        alive = hit & (T.abs().amax(-1) > 0) & (z > 0)
        o = p + ng * torch.sign((ng * wo).sum(-1))[:, None] * OFFSET
        d = wo
        prev_pdf = z / math.pi
        first = False
    return L, queries


def prepare(compiled, device, dtype):
    """The compiled scene's arrays on ``device`` in ``dtype``, with the
    lights' triangles and their pick probabilities (by area)."""
    if compiled["conductor"].any():
        raise ValueError("the reference path tracer renders diffuse scenes only")
    sc = {k: torch.as_tensor(compiled[k], device=device).to(dtype)
          for k in ("p0", "e1", "e2", "ng", "emission", "refl", "area")}
    is_em = torch.as_tensor(compiled["emission"].max(-1) > 0, device=device)
    idx = torch.nonzero(is_em)[:, 0]
    area = sc["area"][idx].double()
    pmf = area / area.sum()
    sc["em_idx"] = idx
    sc["em_pmf"] = pmf.to(dtype)
    sc["em_cdf"] = torch.cumsum(pmf, 0).float().contiguous()
    tri_pmf = torch.zeros_like(sc["area"])
    tri_pmf[idx] = pmf.to(dtype)
    sc["tri_pmf"] = tri_pmf
    return sc


def render_blocks(compiled, width, height, blocks, passes, max_depth, seed, device,
                  dtype=torch.float32, chunk=1 << 19):
    """Mean radiance (by, bx, 3) float64 of each of the (by, bx) ``blocks``
    of pixels over ``passes`` passes of one sample a pixel, and the mean
    closest-hit queries of a path (float)."""
    by, bx = blocks
    sc = prepare(compiled, device, dtype)
    m = torch.as_tensor(compiled["cam_to_world"], device=device)
    rot, org = m[:3, :3].to(dtype), m[:3, 3].to(dtype)
    tan = compiled["tan_half_fov"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    acc = torch.zeros((by * bx, 3), dtype=torch.float64, device=device)
    cnt = torch.zeros((by * bx,), dtype=torch.float64, device=device)
    n_pix = width * height
    queries = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(passes):
        for s in range(0, n_pix, chunk):
            pid = torch.arange(s, min(s + chunk, n_pix), device=device)
            px, py = pid % width, pid // width
            jit = torch.rand((pid.shape[0], 2), generator=gen, device=device).to(dtype)
            fx, fy = px.to(dtype) + jit[:, 0], py.to(dtype) + jit[:, 1]
            dc = torch.stack([(2 * fx / width - 1) * tan, (1 - 2 * fy / height) * tan * height / width,
                              torch.ones_like(fx)], -1)
            d = dc @ rot.T
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
            o = org.expand(d.shape[0], 3)
            L, q = trace(sc, o, d, max_depth, gen, dtype)
            queries += q
            blk = (py * by // height) * bx + px * bx // width
            acc.index_add_(0, blk, L.double())
            cnt.index_add_(0, blk, torch.ones_like(blk, dtype=torch.float64))
    return (acc / cnt[:, None]).reshape(by, bx, 3), float(queries) / (passes * n_pix)
