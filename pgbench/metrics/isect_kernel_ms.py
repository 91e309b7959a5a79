"""isect_kernel_ms: device time of the intersection kernels (pair tiles,
blocklist, BVH, two-level, tiled) per wave of the traced units."""
import re

KERNELS = re.compile(r"(pair|blocklist|bvh|twolevel|intersect_tiled)\w*kernel")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.time_of(KERNELS)
    return t / run.trace_waves * 1e3 if t > 0 else None
