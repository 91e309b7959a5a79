"""keys_ms: device time a wave of the per-ray keys' hash, the program's
``keys`` spans (``wave_keys_and_jitter`` and each bounce's
``bounce_uniform`` in the wavefront ``trace``), over the traced waves."""
from pgbench.metrics._program import device_ms_per


def read(run):
    return device_ms_per("keys", "wave")
