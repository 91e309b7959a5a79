"""The plain reference of the closest-hit and any-hit queries: every
triangle tested against every query ray by Moeller-Trumbore, in blocks
of rays.  A hit lies at t in (EPS_T, tmax), with u, v >= 0 and u + v <= 1,
on a triangle whose |det| is at least 1e-12 (the queries' stated
semantics); the closest hit is the smallest such t.  Plain torch; it
imports nothing of the program."""
import torch

EPS_T = 1e-4


def _mt(p0, e1, e2, o, d):
    """(t, hit) of every (ray, triangle) pair, (R, T)."""
    o, d = o[:, None, :], d[:, None, :]
    pv = torch.linalg.cross(d.expand(-1, e2.shape[0], -1), e2[None].expand(o.shape[0], -1, -1))
    det = (e1[None] * pv).sum(-1)
    ok = det.abs() >= 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)), torch.zeros_like(det))
    tv = o - p0[None]
    u = (tv * pv).sum(-1) * inv
    qv = torch.linalg.cross(tv, e1[None].expand_as(tv))
    v = (d * qv).sum(-1) * inv
    t = (e2[None] * qv).sum(-1) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > EPS_T)
    return t, hit


def queries(tris, o, d, tmax, any_hit, dtype=torch.float64, block=64):
    """Answers of N queries against the triangles ``tris`` = (p0, e1, e2),
    numpy or torch (T, 3): (t (N,) float64, inf on a miss; hit (N,) bool).
    ``any_hit`` (N,) bool marks the shadow queries, whose t is not
    asked.  Computed in ``dtype``: the stated float64, or a lower
    precision for the control."""
    dev = o.device
    p0, e1, e2 = (torch.as_tensor(x, device=dev).to(dtype) for x in tris)
    o, d, tmax = o.to(dtype), d.to(dtype), tmax.to(dtype)
    ts, hits = [], []
    for s in range(0, o.shape[0], block):
        t, hit = _mt(p0, e1, e2, o[s:s + block], d[s:s + block])
        hit = hit & (t < tmax[s:s + block, None])
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        ts.append(t.min(dim=1).values.double())
        hits.append(hit.any(dim=1))
    t = torch.cat(ts) if ts else torch.zeros(0, dtype=torch.float64, device=dev)
    hit = torch.cat(hits) if hits else torch.zeros(0, dtype=torch.bool, device=dev)
    return torch.where(any_hit, float("inf"), t), hit
