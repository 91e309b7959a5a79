#!/usr/bin/env python3
"""Readings of ``correct``'s numbers over many seeds in one process: for
each seed a short window of the cell at its own size, the program's
readings and, with ``--control 1``, the control's (the reference put in
the program's place in the precision below the one the configuration
states: bfloat16 for float32), and each side's verdict under the cell's
limits (``correct``, ``control_correct``): the control has to come out
not correct.  The limits in workloads/<cell>.json lie between the two.
Not part of a benchmark run.

    python3 pgbench/control.py --workload <cell> --seeds 11,12,13 --seconds 4 --control 1

One JSON line a seed on standard output."""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description="program and control readings over seeds")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    from pgbench.harness import spec
    from pgbench.harness.runner import build_program_scene, judge, run_cell

    if not torch.cuda.is_available():
        print("pgbench: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    prebuilt = build_program_scene(cell, torch.device("cuda"))
    for seed in (int(s) for s in args.seeds.split(",")):
        result, compared, ctrl = run_cell(args.workload, seed, args.seconds, prebuilt=prebuilt,
                                          control=bool(args.control))
        limits = {n: lim for n, _, lim in compared}
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": result["correct"],
                          "control_correct": judge(ctrl, limits) if ctrl else None,
                          "program": {n: v for n, v, _ in compared}, "control": ctrl,
                          "metrics": {k: m["value"] for k, m in result["metrics"].items()},
                          "units": result["attempted"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
