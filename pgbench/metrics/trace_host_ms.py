"""trace_host_ms: host time for a call of the wavefront tracer
``integrators.path.trace`` to return, one call a wave, no added
synchronisation (what the host spends enqueueing a wave, and waiting on
the host reads inside it), over the waves after the traced ones."""


def read(run):
    spans = run.spans.get("trace")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
