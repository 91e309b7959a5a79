"""frame_ms: the median latency of the window's frames (frames entry); in a
traced run, of those after the traced ones."""
from pgbench.harness.noise import percentile


def read(run):
    if run.entry != "frames":
        return None
    return percentile(run.host_unit_s, 50) * 1e3
