"""torch.profiler over a traced run's window, reduced to what the
per-layer readers take: every device operation's name and interval, the
busy time (the union of the device intervals), the top device operations
by time, and the longest idle gaps of the device by the host operation
that was running while the device waited."""
import numpy as np
import torch


NOISE = ("void ", "at::native::", "(anonymous namespace)::", "std::array<char*, 2ul>",
         "at::detail::Array<char*, 2>", "unsigned int", "gpu_kernel_impl_nocast<")


def short(name, n=120):
    """A kernel's name without the template noise that hides which one it is."""
    for s in NOISE:
        name = name.replace(s, "")
    return name[:n]


class DeviceTrace:
    def __init__(self, names, starts, ends, host):
        self.names = names          # device operations, in order of start
        self.starts = starts        # seconds, numpy
        self.ends = ends
        self.host = host            # (names, starts, ends) of host operations
        self.busy_s = _union(starts, ends)

    def time_of(self, pattern):
        """Device seconds of the operations whose name matches ``pattern``
        (a compiled regular expression)."""
        dur = self.ends - self.starts
        return float(sum(dur[i] for i, n in enumerate(self.names) if pattern.search(n)))

    def top_ops(self, k=10):
        tot = {}
        for n, s, e in zip(self.names, self.starts, self.ends):
            tot[n] = tot.get(n, 0.0) + float(e - s)
        return sorted(([short(n), v] for n, v in tot.items()), key=lambda x: -x[1])[:k]

    def idle_gaps(self, k=10, longest=400):
        """The device's idle gaps, summed by the innermost host operation
        running at each gap's middle, for the ``longest`` gaps."""
        if len(self.starts) < 2:
            return []
        order = np.argsort(self.starts)
        s, e = self.starts[order], np.maximum.accumulate(self.ends[order])
        gap_start, gap_len = e[:-1], s[1:] - e[:-1]
        pick = np.argsort(-gap_len)[:longest]
        hn, hs, he = self.host
        tot = {}
        for i in pick:
            if gap_len[i] <= 0:
                continue
            mid = gap_start[i] + gap_len[i] / 2
            inside = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = hn[inside[np.argmin(he[inside] - hs[inside])]] if inside.size else "(no host op)"
            tot[name] = tot.get(name, 0.0) + float(gap_len[i])
        return sorted(([short(n), v] for n, v in tot.items()), key=lambda x: -x[1])[:k]


def _union(starts, ends):
    if len(starts) == 0:
        return 0.0
    order = np.argsort(starts)
    busy, cs, ce = 0.0, starts[order[0]], ends[order[0]]
    for i in order[1:]:
        if starts[i] > ce:
            busy += ce - cs
            cs, ce = starts[i], ends[i]
        else:
            ce = max(ce, ends[i])
    return float(busy + ce - cs)


class WindowProfiler:
    """torch.profiler started and stopped around a stretch of the window;
    ``stop`` returns the stretch's DeviceTrace."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.device = device
        self.prof = profile(activities=acts)

    def start(self):
        self.prof.__enter__()

    def stop(self):
        from torch.autograd import DeviceType

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        dev_n, dev_s, dev_e, host_n, host_s, host_e = [], [], [], [], [], []
        for ev in self.prof.events():
            tr = ev.time_range
            if ev.device_type == DeviceType.CUDA:
                dev_n.append(ev.name)
                dev_s.append(tr.start)
                dev_e.append(tr.end)
            else:
                host_n.append(ev.name)
                host_s.append(tr.start)
                host_e.append(tr.end)
        us = 1e-6
        return DeviceTrace(dev_n, np.asarray(dev_s, dtype=np.float64) * us,
                           np.asarray(dev_e, dtype=np.float64) * us,
                           (host_n, np.asarray(host_s, dtype=np.float64) * us,
                            np.asarray(host_e, dtype=np.float64) * us))
