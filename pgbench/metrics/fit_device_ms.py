"""fit_device_ms: device time a progression of the guiding fit, the
program's ``fit`` span (every ``accumulate_stats``, ``update_grid`` and
any ``refine_grid``), over the traced progressions: the device interval
between the span's two events, idle inside it included."""
from pgbench.metrics._program import device_ms_per


def read(run):
    return device_ms_per("fit", "progression")
