"""bounce_intersect_ms: device time a wave of the wavefront bounce's
``intersect`` stage (the closest-hit query and the escaped rays'
environment MIS): the program's ``intersect`` spans at every depth, over
the traced waves."""
from pgbench.metrics._program import device_ms_per


def read(run):
    return device_ms_per("intersect", "wave")
