"""device_ops_per_wave: device operations (kernels, copies, memsets) the
profiler saw over the traced units, per wave."""


def read(run):
    if run.trace is None or not run.trace.names:
        return None
    return len(run.trace.names) / run.trace_waves
