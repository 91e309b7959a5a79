"""splat_ms: device time a wave of the film splat, the program's
``splat`` spans, over the traced waves."""
from pgbench.metrics._program import device_ms_per


def read(run):
    return device_ms_per("splat", "wave")
