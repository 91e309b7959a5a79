"""bounce_nee_ms: device time a wave of the wavefront bounce's ``nee``
stage (next-event estimation, its shadow query included): the program's
``nee`` spans at every depth, over the traced waves."""
from pgbench.metrics._program import device_ms_per


def read(run):
    return device_ms_per("nee", "wave")
