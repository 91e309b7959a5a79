"""How many rays the reference's pair route leaves with a partial result on
door_room(), and what the port does with them.

Camera rays of door_room() (244838 triangles) at 512x512, one sample per
pixel (seed 0, sample 0), pixels [--start, --start + --rays), go through
the pair pipeline with the reference's compaction (``PAIR_CAP`` = 5) in
both packages on the CPU: the JAX package's ``intersect_pairs_raw``
(``use_pallas=False``) and the port's.  The script prints the unproven
count of each, the reference's fallback cap ``max(4096, N >> 4)`` (the
first cap unproven rays by index are re-traced, the rest keep their
nearest-L pair result), and how many of the rays beyond the cap, and of
all rays after the port's fallback (which re-traces every unproven ray),
hit another triangle than the JAX package's BVH route, an oracle that
shares no code with the pair pipeline.

  JAX_PLATFORMS=cpu python tools/pair_fallback_shortfall.py [--start 131072] [--rays 131072]

The defaults, the image's lower half (spheres and floor; the second wave
of a 512x512 render), take about 20 s on a CPU.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

PAIR_CAP = 5
W = H = 512


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--start", type=int, default=131072, help="first pixel of the rays")
    ap.add_argument("--rays", type=int, default=131072)
    args = ap.parse_args(argv)
    import jax.numpy as jnp
    import torch

    from mitsuba_path_guiding_torch.accel.traverse import intersect_pairs_full
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.models.sensor import generate_rays
    from mitsuba_path_guiding_torch.ops.intersect_pairs import intersect_pairs_raw
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room
    from mitsuba_path_guiding_tpu.accel.bvh import build_bvh as j_build_bvh
    from mitsuba_path_guiding_tpu.accel.pairs import build_pair_table as j_build_pair_table
    from mitsuba_path_guiding_tpu.accel.traverse import _fallback_cap, intersect_bvh
    from mitsuba_path_guiding_tpu.ops.intersect_pairs import intersect_pairs_raw as j_raw
    from mitsuba_path_guiding_tpu.scene.types import Geometry as JGeometry

    t0 = time.time()
    scene = build_scene(door_room(), device="cpu")
    p0, e1, e2 = (x.numpy() for x in (scene.geo.p0, scene.geo.e1, scene.geo.e2))
    jbvh = j_build_bvh(p0, e1, e2)
    jpt = j_build_pair_table(p0, e1, e2, jbvh)

    pix = torch.arange(args.start, args.start + args.rays)
    rkeys = rng.ray_keys(rng.base_key(0), pix, torch.zeros_like(pix))
    o, d, _ = generate_rays(scene.sensor, W, H, pix, rng.event_uniform(rkeys, rng.TAG_CAMERA, 2))
    n = o.shape[0]
    tmax = torch.full((n,), 3.0e37)
    jo, jd, jtmax = (jnp.asarray(x.numpy()) for x in (o, d, tmax))

    oracle = np.asarray(intersect_bvh(JGeometry(jnp.asarray(p0), jnp.asarray(e1),
                                                jnp.asarray(e2), *([None] * 10)),
                                      jbvh, jo, jd, jtmax).prim)
    want = j_raw(jpt, jo, jd, jtmax, use_pallas=False, cap_factor=PAIR_CAP)
    j_prim, j_proven = np.asarray(want[1]), np.asarray(want[5])
    got = intersect_pairs_raw(scene.pairs, o, d, tmax, cap_factor=PAIR_CAP)
    proven = got[5].numpy()
    full = intersect_pairs_full(scene.pairs, scene.blocks, o, d, tmax, cap_factor=PAIR_CAP)

    cap = _fallback_cap(n)
    unproven_idx = np.nonzero(~j_proven)[0]
    left = unproven_idx[cap:]   # beyond the reference's cap: the pair result stays
    print(json.dumps({
        "scene": "door_room()", "triangles": int(p0.shape[0]), "resolution": f"{W}x{H}",
        "pixels": [args.start, args.start + n], "cap_factor": PAIR_CAP,
        "jax_unproven": int(unproven_idx.size), "port_unproven": int((~proven).sum()),
        "proven_flags_equal": float((proven == j_proven).mean()),
        "jax_fallback_cap": cap, "jax_left_with_pair_result": int(left.size),
        "jax_left_wrong_vs_bvh": int((j_prim[left] != oracle[left]).sum()),
        "jax_left_missing_hit": int(((j_prim[left] < 0) & (oracle[left] >= 0)).sum()),
        "port_full_wrong_vs_bvh": int((full.prim.numpy() != oracle).sum()),
        "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
