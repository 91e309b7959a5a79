"""fused_roofline: the fused path kernel's share of its compute roofline.
Work: every closest-hit query of a path segment tests every triangle of
the scene (the fused scenes have no acceleration structure), at MT_FLOPS
operations a test.  The queries are counted by the benchmark, not by the
kernel: the traced samples times the closest-hit queries a path of the
reference path tracer asked on the same scene (``work``, set by the
``image`` check).  Shadow rays are left out, so the share understates the
kernel's.  Least time: that work at the published float32 peak; the share
is the least time over the kernel's device time."""
import re

from pgbench.harness.peaks import FP32_FLOPS, MT_FLOPS

KERNEL = re.compile(r"trace_fused_kernel")


def work_flops(run):
    """Operations of the traced samples' closest-hit queries, or None."""
    per_path = run.work.get("queries_per_path")
    if run.trace is None or not run.trace_samples or not per_path:
        return None
    return run.trace_samples * per_path * run.n_tri * MT_FLOPS


def read(run):
    flops = work_flops(run)
    t = run.trace.time_of(KERNEL) if flops else 0.0
    if t <= 0:
        return None
    return flops / FP32_FLOPS / t * 100.0
