#!/usr/bin/env python3
"""The benchmark of mitsuba_path_guiding_torch: one run of one cell.

    python3 pgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs from the root of a checkout on a machine with the cards the cell
asks for (BENCHMARK.json); without them it prints no result and exits 3.
With ``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer ones (torch.profiler over the window).
The last lines of standard error and the result line's last key,
``checks``, give each number that decided ``correct`` beside its limit.
The last line of standard output is the result, one JSON object."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    t_torch = time.perf_counter() - T_START
    from pgbench.harness import spec
    from pgbench.harness.runner import forbidden_modules, run_cell

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"pgbench: the cell needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(4)
    result, compared, _ = run_cell(args.workload, args.seed, args.seconds, trace=bool(args.trace),
                                   t_start=T_START)
    result["setup_parts"]["torch_imported"] = t_torch
    result["checks"] = result.pop("checks")
    found = forbidden_modules()
    if found:
        print(f"pgbench: modules that a run may not load were loaded: {found}", file=sys.stderr)
        return 4
    for number, value, limit in compared:
        print(f"check {number} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
