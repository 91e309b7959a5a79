"""Check ``scene``: the program's compiled triangles against the
reference's compile of the same frozen description.  One number,
``scene_gap``: the widest gap of a corner, edge, unit geometric normal or
emitted radiance, over the largest magnitude of that field."""
import numpy as np
import torch

FIELDS = ("p0", "e1", "e2", "ng", "emission")


def program_side(scene):
    geo = scene.geo
    return {"p0": geo.p0, "e1": geo.e1, "e2": geo.e2,
            "ng": geo.shade_packed[:, 0:3], "emission": geo.shade_packed[:, 20:23]}


def _gap(prog, ref):
    if prog["p0"].shape[0] != ref["p0"].shape[0]:
        return float("inf")
    worst = 0.0
    for f in FIELDS:
        p = torch.as_tensor(prog[f]).double().cpu().numpy()
        r = np.asarray(ref[f], dtype=np.float64)
        worst = max(worst, float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-12)))
    return worst


def readings(ctx, out, params, control=False):
    ref = ctx.compiled
    prog = out["scene"]
    if control:
        prog = {f: torch.as_tensor(ref[f]).to(torch.bfloat16) for f in FIELDS}
    return {"scene_gap": _gap(prog, ref)}
