"""device_idle: the share of the traced stretch of the window in which no
device operation ran: 1 - (the union of the device operations'
intervals) / (the stretch)."""


def read(run):
    if run.trace is None or not run.trace.names:
        return None
    return (1.0 - run.trace.busy_s / run.trace_wall) * 100.0
