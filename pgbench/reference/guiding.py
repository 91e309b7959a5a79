"""The plain reference of one update of the guiding cache: the E-step of
each path vertex against the cell that holds it (a uniform root grid
walked down an octree of ``child_base`` rows), the per-cell sums of the
responsibility-weighted directions, counts, inverse distances and
positions, and the M-step that blends them into the running statistics
(factor EMA) and refits each cell's von Mises-Fisher mixture: lobe
weights with a floor, mean directions, concentrations from the mean
cosine (Banerjee et al.), the parallax origin and the lobes' distances.

The cache's parameters are read rounded to bfloat16, which is how the
guiding cache is defined to be read; everything else is computed in the
``dtype`` asked for (float64 for the reference, lower for the control).
Plain torch; it imports nothing of the program."""
import math

import torch

MIN_SAMPLES_VALID = 32.0
ALPHA_R_LO, ALPHA_R_HI = 0.2, 0.6
EMA = 0.7
WEIGHT_FLOOR = 1e-3
KAPPA_FIT_MAX = 5e3
KAPPA_MAX = 1e4
LEVELS = 3


def _cell_index(g, pos):
    res = g["res0"]
    ext = torch.clamp_min(g["aabb_max"] - g["aabb_min"], 1e-6)
    q = torch.clamp((pos - g["aabb_min"]) / ext, 0.0, 1.0 - 1e-6) * res
    ijk = q.to(torch.int64)
    cid = (ijk[:, 0] * res + ijk[:, 1]) * res + ijk[:, 2]
    frac = q - ijk
    for _ in range(LEVELS):
        base = g["child_base"][cid].to(torch.int64)
        hi = (frac >= 0.5).to(torch.int64)
        octant = (hi[:, 0] * 2 + hi[:, 1]) * 2 + hi[:, 2]
        inner = base >= 0
        cid = torch.where(inner, base + octant, cid)
        frac = torch.where(inner[:, None], frac * 2.0 - hi, frac)
    return cid


def _vmf_pdf(t, kappa):
    kk = torch.clamp(kappa, 0.0, KAPPA_MAX)
    denom = 2.0 * math.pi * -torch.expm1(-2.0 * kk)
    norm = torch.where(kk > 1e-6, kk / torch.clamp_min(denom, 1e-30),
                       torch.full_like(kk, 1.0 / (4.0 * math.pi)))
    return norm * torch.exp(kk * (torch.clamp(t, -1.0, 1.0) - 1.0))


def statistics(g, records, dtype, block=1 << 21):
    """Per-cell sums of a progression's path records (a list of dicts of
    pos (D, 3, N), dir, li, pdf, valid, dist) against cache ``g``."""
    c, k = g["kappa"].shape
    dev = g["kappa"].device
    read = {f: g[f].to(torch.bfloat16).to(dtype) for f in ("mu", "kappa", "log_weight")}
    sums = {"s_w": torch.zeros((c, k), dtype=dtype, device=dev),
            "s_dir": torch.zeros((c, k, 3), dtype=dtype, device=dev),
            "s_count": torch.zeros((c,), dtype=dtype, device=dev),
            "s_rho": torch.zeros((c, k), dtype=dtype, device=dev),
            "s_pos": torch.zeros((c, 3), dtype=dtype, device=dev),
            "s_pos_w": torch.zeros((c,), dtype=dtype, device=dev)}
    for rec in records:
        flat = {"pos": rec["pos"].permute(0, 2, 1).reshape(-1, 3),
                "dir": rec["dir"].permute(0, 2, 1).reshape(-1, 3)}
        flat.update({f: rec[f].reshape(-1) for f in ("li", "pdf", "valid", "dist")})
        for s in range(0, flat["li"].shape[0], block):
            _add_block(sums, g, read, {f: x[s:s + block] for f, x in flat.items()}, dtype)
    return sums


def _add_block(sums, g, read, rec, dtype):
    k = read["kappa"].shape[1]
    cell_ok = g["valid"]
    pos, dirs = rec["pos"], rec["dir"].to(dtype)
    li, pdf = rec["li"].to(dtype), rec["pdf"].to(dtype)
    valid, dist = rec["valid"], rec["dist"].to(dtype)
    w = torch.where(valid, li / torch.clamp_min(pdf, 1e-3), torch.zeros_like(li))
    w = torch.clamp_max(w, 1e4)
    cid = _cell_index(g, pos.to(torch.float32))
    mu, kappa = read["mu"][cid], read["kappa"][cid]            # (M, K, 3), (M, K)
    wmix = torch.softmax(read["log_weight"][cid], dim=-1)
    t = (mu * dirs[:, None, :]).sum(-1)
    resp = wmix * torch.clamp_min(_vmf_pdf(t, kappa), 1e-12)
    resp = resp / torch.clamp_min(resp.sum(-1, keepdim=True), 1e-12)
    resp = torch.where(cell_ok[cid][:, None], resp, torch.full_like(resp, 1.0 / k))
    rw = resp * w[:, None]
    inv_d = torch.where((dist > 1e-5) & (dist < 1e7), 1.0 / dist, torch.zeros_like(dist))
    posd = pos.to(dtype)
    sums["s_w"].index_add_(0, cid, rw)
    sums["s_dir"].index_add_(0, cid, rw[:, :, None] * dirs[:, None, :])
    sums["s_count"].index_add_(0, cid, valid.to(dtype))
    sums["s_rho"].index_add_(0, cid, rw * inv_d[:, None])
    sums["s_pos"].index_add_(0, cid, w[:, None] * posd)
    sums["s_pos_w"].index_add_(0, cid, w)


def update(g, sums, dtype):
    """The cache after the M-step, as a dict of fields in ``dtype``."""
    old = {f: g[f].to(dtype) for f in ("s_w", "s_dir", "s_count", "s_rho", "s_pos", "s_pos_w",
                                       "mu", "kappa", "origin")}
    s_w = old["s_w"] * EMA + sums["s_w"]
    s_dir = old["s_dir"] * EMA + sums["s_dir"]
    s_count = old["s_count"] * EMA + sums["s_count"]
    total = s_w.sum(-1, keepdim=True)
    weight = torch.clamp_min(s_w / torch.clamp_min(total, 1e-12), WEIGHT_FLOOR)
    weight = weight / weight.sum(-1, keepdim=True)
    norm_dir = torch.linalg.norm(s_dir, dim=-1)
    r = torch.clamp(norm_dir / torch.clamp_min(s_w, 1e-12), 0.0, 0.9999)
    kappa_fit = torch.clamp(r * (3.0 - r * r) / torch.clamp_min(1.0 - r * r, 1e-6), 0.0, KAPPA_MAX)
    kappa_fit = torch.clamp(kappa_fit, 1e-2, KAPPA_FIT_MAX)
    lobe_ok = (s_w > 1e-9) & (norm_dir > 1e-12)
    mu = torch.where(lobe_ok[..., None], s_dir / torch.clamp_min(norm_dir, 1e-12)[..., None],
                     old["mu"])
    r_bar = torch.linalg.norm(s_dir.sum(1), dim=-1) / torch.clamp_min(total[:, 0], 1e-12)
    s_rho = old["s_rho"] * EMA + sums["s_rho"]
    s_pos = old["s_pos"] * EMA + sums["s_pos"]
    s_pos_w = old["s_pos_w"] * EMA + sums["s_pos_w"]
    return {
        "mu": mu,
        "kappa": torch.where(lobe_ok, kappa_fit, old["kappa"]),
        "log_weight": torch.log(weight),
        "valid": (total[:, 0] > 1e-9) & (s_count > MIN_SAMPLES_VALID),
        "s_w": s_w, "s_dir": s_dir, "s_count": s_count,
        "alpha_scale": torch.clamp((r_bar - ALPHA_R_LO) / (ALPHA_R_HI - ALPHA_R_LO), 0.0, 1.0),
        "s_rho": s_rho, "s_pos": s_pos, "s_pos_w": s_pos_w,
        "origin": torch.where((s_pos_w > 1e-9)[:, None],
                              s_pos / torch.clamp_min(s_pos_w, 1e-12)[:, None], old["origin"]),
        "lobe_dist": torch.where(s_rho > 1e-9, s_w / torch.clamp_min(s_rho, 1e-12),
                                 torch.zeros_like(s_rho)),
    }
