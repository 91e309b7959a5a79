"""idle_in_program: the share of the traced stretch in which no device
operation ran while the host was inside one of the program's ``mpg/``
ranges: the overlap of the device's idle intervals with the union of
the program's ranges, over the stretch (``device_idle``'s base)."""
import numpy as np


def _merged(starts, ends):
    """Sorted disjoint intervals covering the given ones."""
    out = []
    for s, e in sorted(zip(starts.tolist(), ends.tolist())):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a, b):
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    if run.trace is None or not run.trace.names:
        return None
    names, hs, he = run.trace.host
    pick = np.asarray([n.startswith("mpg/") for n in names], dtype=bool)
    if not pick.any():
        return None
    program = _merged(hs[pick], he[pick])
    inside = sum(e - s for s, e in program)
    busy = _merged(run.trace.starts, run.trace.ends)
    return (inside - _overlap(program, busy)) / run.trace_wall * 100.0
