"""Render statistics: global counters + end-of-job report.

Counterpart of Mitsuba's lock-free StatsCounter registry
(include/mitsuba/core/statistics.h and Statistics::printStats, printed
by mitsuba.cpp at job end).
Host-side here: device code returns aggregate numbers (path segments,
sample counts) that the orchestrators feed into these counters.
"""
from __future__ import annotations

import time
from collections import defaultdict


class StatsRegistry:
    def __init__(self):
        self._counters = defaultdict(float)
        self._averages = defaultdict(lambda: [0.0, 0.0])  # sum, count
        self._t0 = time.time()

    def add(self, name: str, value: float = 1.0):
        self._counters[name] += value

    def average(self, name: str, value: float, weight: float = 1.0):
        s = self._averages[name]
        s[0] += value
        s[1] += weight

    def get(self, name: str) -> float:
        if name in self._averages:
            s = self._averages[name]
            return s[0] / max(s[1], 1e-12)
        return self._counters[name]

    def reset(self):
        self._counters.clear()
        self._averages.clear()
        self._t0 = time.time()

    def report(self) -> str:
        """Formatted report (reference Statistics::printStats)."""
        lines = ["  Render statistics:"]
        elapsed = time.time() - self._t0
        for name in sorted(self._counters):
            v = self._counters[name]
            if v >= 1e6:
                lines.append(f"    {name:<32s} {v / 1e6:10.2f} M")
            else:
                lines.append(f"    {name:<32s} {v:10.0f}")
        for name in sorted(self._averages):
            lines.append(f"    {name:<32s} {self.get(name):10.3f} (avg)")
        if "rays traced" in self._counters and elapsed > 0:
            lines.append(
                f"    {'throughput':<32s} {self._counters['rays traced'] / elapsed / 1e6:10.2f} Mrays/s"
            )
        lines.append(f"    {'elapsed':<32s} {elapsed:10.1f} s")
        return "\n".join(lines)


GLOBAL_STATS = StatsRegistry()
