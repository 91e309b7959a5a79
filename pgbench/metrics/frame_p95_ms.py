"""frame_p95_ms: the 95th percentile of the latency of every frame of the
window (frames entry), host clock to a synchronisation."""
from pgbench.harness.noise import percentile


def read(run):
    if run.entry != "frames":
        return None
    return percentile(run.unit_s, 95) * 1e3
