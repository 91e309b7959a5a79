"""Check ``hits``: the closest-hit and any-hit queries that the window's
waves asked, a fixed number of lanes of each query drawn from the seed,
answered again by the reference (every triangle of the reference's own
compile tested in float64).  Numbers, each a share of the live queries
(tmax > 0): ``hit_mismatch``, those whose hit or occlusion differs, and
``hit_t_share``, the closest-hit queries hit on both sides whose distance
differs by more than T_TOL of max(distance, 0.01).  A share and not the
widest gap: a ray within ~1e-5 of an edge shared by two triangles can
pass between them in float32 (Moeller-Trumbore is not watertight) and
hit a farther surface, once in tens of thousands of queries."""
import torch

from pgbench.reference.hits import queries

T_TOL = 1e-3


def readings(ctx, out, params, control=False):
    rows = out["hits"]
    if rows is None or rows.shape[0] == 0:
        return {"hit_mismatch": float("inf"), "hit_t_share": float("inf")}
    rows = rows.to(ctx.device)
    o, d, tmax = rows[:, 0:3], rows[:, 3:6], rows[:, 6]
    t_p, hit_p, any_hit = rows[:, 7].double(), rows[:, 8] > 0.5, rows[:, 9] > 0.5
    tris = tuple(ctx.compiled[k] for k in ("p0", "e1", "e2"))
    block = int(params.get("block", 64))
    t_r, hit_r = queries(tris, o.double(), d.double(), tmax.double(), any_hit, block=block)
    if control:
        t_p, hit_p = queries(tris, o, d, tmax, any_hit, dtype=torch.bfloat16, block=block)
    live = tmax > 0
    n_live = max(int(live.sum()), 1)
    mismatch = float(((hit_p != hit_r) & live).sum()) / n_live
    closest = live & ~any_hit
    both = closest & hit_p & hit_r
    far = both & ((t_p - t_r).abs() > T_TOL * torch.clamp_min(t_r, 0.01))
    return {"hit_mismatch": mismatch,
            "hit_t_share": float(far.sum()) / max(int(closest.sum()), 1)}
