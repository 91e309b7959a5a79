"""host_syncs_per_wave: the program's deliberate device-to-host reads
(``host_read``, counted by site) over the traced units, per wave."""
from pgbench.metrics._program import stretch


def read(run):
    got = stretch()
    if got is None:
        return None
    records, reads = got
    return sum(reads.values()) / sum(r.name == "wave" for r in records)
