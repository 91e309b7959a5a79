"""The spread of guiding's equal-spp gain on door_room, on one card.

chip_smoke.py's door_room recipe (``door_gain_run``: 512x512 through the
BVH, a 40-spp reference, 4 unguided spp, 4 refined fitting progressions,
4 guided spp) for key seeds 0..N-1, seed 0 twice (a fit that repeats bit
for bit gives the same relMSE twice), then seed 0 with the fit's per-cell
sums taken by ``index_add_`` (float atomics, added in the order the threads
arrive) a few times, and the JAX package's 96x96 test recipe on
door_room(60000) (tests/test_guiding.py
test_door_room_guiding_gain_equal_spp) for the same seeds.  First, the
per-cell sums of one payload through ``cell_sums`` and through
``index_add_``, each called repeatedly: how many distinct results.

One JSON object a line on stdout, and in --out when given.

  python3 tools/guiding_gain_spread.py [--seeds 8] [--atomic-repeats 3]
      [--out results.jsonl]
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--atomic-repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from mitsuba_path_guiding_torch.guiding import fit
    from mitsuba_path_guiding_torch.ops import build
    from mitsuba_path_guiding_torch.scene.builder import build_scene
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    out = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()

    # the per-cell sums of one wave-sized payload, called five times each way
    g = torch.Generator(device="cuda").manual_seed(3)
    rows, n_cells = chip_smoke.DEPTH * chip_smoke.DOOR_W * chip_smoke.DOOR_H, 4 * 16**3
    cid = (torch.rand((rows,), generator=g, device="cuda") ** 4 * n_cells).long()
    payload = torch.randn((rows, 45), generator=g, device="cuda")

    def index_add_sums(n, c, p):
        return torch.zeros((n, p.shape[1]), device=p.device).index_add_(0, c, p)

    on_cpu = index_add_sums(n_cells, cid.cpu(), payload.cpu())
    for name, fn in (("cell_sums", fit.cell_sums), ("index_add_", index_add_sums)):
        res = [fn(n_cells, cid, payload) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(10):
            fn(n_cells, cid, payload)
        torch.cuda.synchronize()
        distinct = len({r.cpu().numpy().tobytes() for r in res})
        emit({"sums": name, "rows": rows, "calls": 5, "distinct_results": distinct,
              "ms_per_call": (time.time() - t0) * 100.0,
              "equals_cpu_row_order": bool(torch.equal(res[0].cpu(), on_cpu)),
              "max_abs_vs_cpu": float((res[0].cpu() - on_cpu).abs().max())})

    def run(scene, label, seed, **kw):
        t0 = time.time()
        r = chip_smoke.door_gain_run(scene, seed=seed, **kw)
        emit({"recipe": label, "card": card, "seed": seed, "relmse_unguided": r["r_u"],
              "relmse_guided": r["r_g"], "gain": r["gain"], "n_used": r["n_used"],
              "seconds": time.time() - t0})
        return r["gain"]

    def summary(label, gains):
        emit({"recipe": label, "seeds": len(gains), "gains": gains,
              "mean": statistics.mean(gains), "stdev": statistics.stdev(gains),
              "min": min(gains), "max": max(gains),
              "below_1.10": sum(x <= 1.10 for x in gains)})

    door = build_scene(door_room(), device="cuda")
    big = [run(door, "door_room_512", s) for s in range(args.seeds)]
    run(door, "door_room_512_repeat", 0)
    summary("door_room_512", big)
    kept = fit.cell_sums
    fit.cell_sums = index_add_sums
    try:
        for _ in range(args.atomic_repeats):
            run(door, "door_room_512_index_add", 0)
    finally:
        fit.cell_sums = kept
    del door
    torch.cuda.empty_cache()

    small = build_scene(door_room(60_000), device="cuda")
    twin = dict(width=96, height=96, reference=(200, 24), window=(600, 4), progressions=3,
                threshold=256.0)
    summary("door_room60k_96", [run(small, "door_room60k_96", s, **twin)
                                for s in range(args.seeds)])
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
