"""The program's own spans and host-read counter over the traced units.

``mitsuba_path_guiding_torch.utils.stats.RECORDER`` keeps the spans and
host reads of its last recording stretch; spans record exactly while a
profiler records, so after a traced run that stretch is the traced
units.  A program without the recorder, or a run with no stretch, gives
None, and its metrics are left out of the line."""


def stretch():
    """(span records, host reads by site) of the last stretch, or None."""
    try:
        from mitsuba_path_guiding_torch.utils import stats
    except ImportError:
        return None
    recorder = getattr(stats, "RECORDER", None)
    if recorder is None:
        return None
    records = recorder.records()
    if not any(r.name == "wave" for r in records):
        return None
    return records, recorder.host_reads


def device_ms_per(name, unit):
    """Device ms of the spans ``name`` over the number of spans ``unit``;
    None where the stretch has none of either."""
    got = stretch()
    if got is None:
        return None
    records = got[0]
    n_unit = sum(r.name == unit for r in records)
    spans = [r.device_ms for r in records if r.name == name]
    if not spans or not n_unit:
        return None
    return sum(spans) / n_unit
