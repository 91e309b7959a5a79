"""fused_kernel_ms: device time of the fused path kernel (trace_fused)
per wave of the traced units."""
import re

KERNEL = re.compile(r"trace_fused_kernel")


def read(run):
    if run.trace is None:
        return None
    t = run.trace.time_of(KERNEL)
    return t / run.trace_waves * 1e3 if t > 0 else None
