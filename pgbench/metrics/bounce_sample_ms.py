"""bounce_sample_ms: device time a wave of the wavefront bounce's
``sample`` stage (guided or BSDF sampling, roulette, the path records
and the state update): the program's ``sample`` spans at every depth,
over the traced waves."""
from pgbench.metrics._program import device_ms_per


def read(run):
    return device_ms_per("sample", "wave")
