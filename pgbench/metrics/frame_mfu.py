"""frame_mfu: the whole frame's share of the card's float32 peak: the
fused kernel's counted work (fused_roofline's, from the reference's
queries a path) over the traced frames' host time at the published
peak."""
from pgbench.harness.peaks import FP32_FLOPS
from pgbench.metrics.fused_roofline import work_flops


def read(run):
    flops = work_flops(run) if run.entry == "frames" else None
    if not flops:
        return None
    return flops / FP32_FLOPS / run.trace_unit_s * 100.0
