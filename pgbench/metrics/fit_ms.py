"""fit_ms: host time a progression spends in the guiding fit (every
``accumulate_stats`` and the ``update_grid`` call, each span synchronised
at its end), over the progressions after the traced ones."""


def read(run):
    spans = run.spans.get("fit")
    if not spans:
        return None
    return sum(spans) / run.host_units * 1e3
