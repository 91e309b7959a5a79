"""Render statistics: global counters + end-of-job report, and the
program's spans and host-read counts.

Counterpart of Mitsuba's lock-free StatsCounter registry
(include/mitsuba/core/statistics.h and Statistics::printStats, printed
by mitsuba.cpp at job end).
Host-side here: device code returns aggregate numbers (path segments,
sample counts) that the orchestrators feed into these counters.  A 0-d
tensor fed in stays on its device, summed there, and is read back only
by ``get`` and ``report``.

Spans (``span``) and the host-read counter (``host_read``) record only
while a torch profiler is recording or inside ``tracing()``; otherwise a
span site costs one flag check.  A recorded span opens a profiler range
"mpg/<name>" (a host range on the profiler's clock that adds no device
event), records a pair of CUDA timing events on the current stream when
its unit runs on the card (else the host interval), and keeps a
``SpanRecord``.  A unit is a span opened outside every other (a
progression, a frame); its records share its number.  The events are
read when ``RECORDER.records()`` is called, after the units have ended,
never inside a span.  A recording stretch (one profiler window, one
``tracing()`` block) replaces the previous stretch's records and counts.
"""
from __future__ import annotations

import contextlib
import time
from collections import Counter, defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

# records kept a stretch; spans past it are counted in ``dropped``
SPAN_CAP = 1 << 16


# device values a counter holds before they are folded into one
FOLD_EVERY = 256


class StatsRegistry:
    def __init__(self):
        self._counters = defaultdict(float)
        self._averages = defaultdict(lambda: [0.0, 0.0])  # sum, count
        self._device = defaultdict(list)  # (kind, name): device values not yet read
        self._t0 = time.time()

    def _keep(self, key, value: torch.Tensor):
        held = self._device[key]
        held.append(value.detach())
        if len(held) >= FOLD_EVERY:
            held[:] = [sum(held[1:], held[0])]

    def _read(self, key):
        """The sum of the device values of ``key`` (one host read), 0 if none."""
        held = self._device.get(key)
        if not held:
            return 0
        held[:] = [sum(held[1:], held[0])]
        return held[0].item()

    def add(self, name: str, value: float = 1.0):
        if torch.is_tensor(value):
            self._keep(("add", name), value)
            value = 0.0  # the name is listed; its device part is read later
        self._counters[name] += value

    def average(self, name: str, value: float, weight: float = 1.0):
        s = self._averages[name]
        if torch.is_tensor(value):
            self._keep(("average", name), value)
        else:
            s[0] += value
        s[1] += weight

    def _total(self, name: str) -> float:
        return self._counters[name] + self._read(("add", name))

    def get(self, name: str) -> float:
        if name in self._averages:
            s = self._averages[name]
            return (s[0] + self._read(("average", name))) / max(s[1], 1e-12)
        return self._total(name)

    def reset(self):
        self._counters.clear()
        self._averages.clear()
        self._device.clear()
        self._t0 = time.time()

    def report(self) -> str:
        """Formatted report (reference Statistics::printStats)."""
        lines = ["  Render statistics:"]
        elapsed = time.time() - self._t0
        counters = {name: self._total(name) for name in list(self._counters)}
        for name in sorted(counters):
            v = counters[name]
            if v >= 1e6:
                lines.append(f"    {name:<32s} {v / 1e6:10.2f} M")
            else:
                lines.append(f"    {name:<32s} {v:10.0f}")
        for name in sorted(self._averages):
            lines.append(f"    {name:<32s} {self.get(name):10.3f} (avg)")
        if "rays traced" in counters and elapsed > 0:
            lines.append(
                f"    {'throughput':<32s} {counters['rays traced'] / elapsed / 1e6:10.2f} Mrays/s"
            )
        lines.append(f"    {'elapsed':<32s} {elapsed:10.1f} s")
        return "\n".join(lines)


GLOBAL_STATS = StatsRegistry()


class SpanRecord:
    """One recorded span: ``parent`` is the index of the enclosing span's
    record in the stretch (None for a unit or a dropped parent), ``unit``
    the unit's number in the stretch, ``wave`` the index within the unit
    of the enclosing wave (None outside waves), ``depth`` the bounce of a
    bounce stage; host times in ns (``time.perf_counter_ns``)."""

    __slots__ = ("name", "parent", "unit", "wave", "depth", "host_start_ns", "host_end_ns",
                 "_events", "_device_ms")

    def __init__(self, name, parent, unit, wave, depth, host_start_ns, events):
        self.name, self.parent, self.unit, self.wave, self.depth = name, parent, unit, wave, depth
        self.host_start_ns = host_start_ns
        self.host_end_ns = None
        self._events = events
        self._device_ms = None

    @property
    def device_ms(self) -> float:
        """The span's time on its stream (idle inside it included); the host
        interval for a unit on the CPU."""
        if self._device_ms is None:
            if self._events is None:
                self._device_ms = (self.host_end_ns - self.host_start_ns) / 1e6
            else:
                start, end = self._events
                end.synchronize()
                self._device_ms = start.elapsed_time(end)
                self._events = None
        return self._device_ms


class _Span:
    __slots__ = ("rec", "name", "depth", "device", "record", "index", "_range", "_end")

    def __init__(self, rec, name, depth, device):
        self.rec, self.name, self.depth, self.device = rec, name, depth, device

    def __enter__(self):
        rec = self.rec
        parent = rec._stack[-1] if rec._stack else None
        if parent is None:
            rec._unit += 1
            rec._waves = 0
            rec._wave = None
        if self.device is not None:
            self.device = torch.device(self.device)
        elif parent is not None:
            self.device = parent.device
        if self.name == "wave":
            rec._wave = rec._waves
            rec._waves += 1
        self._range = _RecordFunctionFast("mpg/" + self.name)
        self._range.__enter__()
        events = self._end = None
        if self.device is not None and self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            start.record()
            events = (start, self._end)
        self.index = None
        if len(rec._records) < SPAN_CAP:
            self.index = len(rec._records)
            self.record = SpanRecord(self.name, parent.index if parent else None, rec._unit,
                                     rec._wave, self.depth, time.perf_counter_ns(), events)
            rec._records.append(self.record)
        else:
            self.record = None
            rec.dropped += 1
        rec._stack.append(self)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if self._end is not None:
            self._end.record()
        if self.record is not None:
            self.record.host_end_ns = time.perf_counter_ns()
        self._range.__exit__(*exc)
        rec._stack.pop()
        if self.name == "wave":
            rec._wave = None
        return False


class Recorder:
    """The spans and host reads of the last recording stretch."""

    def __init__(self):
        self._forced = 0
        self._live = False
        self._stack = []
        self._begin()

    def _begin(self):
        self._records = []
        for open_span in self._stack:  # spans still open belong to the last stretch
            open_span.index = open_span.record = None
        self._unit = -1
        self._waves = 0
        self._wave = None
        self.dropped = 0
        self.host_reads = Counter()

    def on(self) -> bool:
        """Whether spans record now; the first check of a stretch begins it."""
        live = self._forced > 0 or _profiler_enabled()
        if live and not self._live:
            self._begin()
        self._live = live
        return live

    def records(self) -> list:
        """The stretch's span records, their device times readable."""
        return list(self._records)


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def span(name: str, depth: int | None = None, device=None):
    """A context that records span ``name`` while recording is on.
    ``device``: where the unit's tensors live (a unit gives it; spans
    inside take their parent's)."""
    if not RECORDER.on():
        return _OFF
    return _Span(RECORDER, name, depth, device)


def host_read(x: torch.Tensor, site: str) -> torch.Tensor:
    """``x`` on the host: a deliberate device-to-host read, counted by
    ``site`` while recording is on."""
    if RECORDER.on():
        RECORDER.host_reads[site] += 1
    return x.cpu()


@contextlib.contextmanager
def tracing():
    """Record spans and host reads inside the block, with or without a
    profiler; entering it begins a new stretch."""
    if RECORDER._forced == 0:
        RECORDER._live = False
    RECORDER._forced += 1
    try:
        RECORDER.on()
        yield RECORDER
    finally:
        RECORDER._forced -= 1
