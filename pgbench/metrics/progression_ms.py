"""progression_ms: the median host time of the window's progressions
(progressive and sharded entries), each ending in a host read; in a
traced run, of those after the traced ones."""
from pgbench.harness.noise import percentile


def read(run):
    if run.entry not in ("progressive", "sharded"):
        return None
    return percentile(run.host_unit_s, 50) * 1e3
