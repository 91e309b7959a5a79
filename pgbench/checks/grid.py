"""Check ``grid``: the guiding cache's update of the window's last
progression, worked out again by the reference from the cache before it
and that progression's path records (the program's own state: the
reference follows it one step).  One number, ``grid_gap``: over the
cache's fields, the largest norm of the program's field minus the
reference's, over the norm of the reference's."""
import torch

from pgbench.reference.guiding import statistics, update

FIELDS = ("mu", "kappa", "log_weight", "valid", "s_w", "s_dir", "s_count", "alpha_scale",
          "s_rho", "s_pos", "s_pos_w", "origin", "lobe_dist")
INPUT = FIELDS + ("aabb_min", "aabb_max", "child_base")


def program_side(grid_step):
    """Plain tensors of the probe's (cache before, records, cache after)."""
    before, recs, after = grid_step
    g0 = {f: getattr(before, f) for f in INPUT}
    g0["res0"] = int(before.res0)
    records = [{f: getattr(r, f) for f in ("pos", "dir", "li", "pdf", "valid", "dist")}
               for r in recs]
    return g0, records, {f: getattr(after, f) for f in FIELDS}


def _field_gap(p, r):
    p, r = p.double(), r.double()
    return float(torch.linalg.norm(p - r) / torch.clamp_min(torch.linalg.norm(r), 1e-30))


def readings(ctx, out, params, control=False):
    g0, records, prog = out["grid"]
    ref = update(g0, statistics(g0, records, torch.float64), torch.float64)
    if control:
        prog = update(g0, statistics(g0, records, torch.bfloat16), torch.bfloat16)
    return {"grid_gap": max(_field_gap(prog[f], ref[f]) for f in FIELDS)}
