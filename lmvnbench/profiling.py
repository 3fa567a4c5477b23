"""The traced window: the reduction of a ``torch.profiler`` trace to what
the per-layer readers read.

Device time is the union of the device's activity intervals (kernels,
copies, fills), as ``scripts/profile_torch_fused.py``'s ``busy_ms`` takes
it; the idle share is one less that union over the window's wall time.
The benchmark's own ranges (``record_function``, named ``lmvnbench.*``)
appear on the device as annotations: they are spans, not activity.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

RANGE_PREFIX = "lmvnbench."
REQUEST_RANGE = RANGE_PREFIX + "request"
FORWARD_RANGE = RANGE_PREFIX + "forward_spectra"


@dataclasses.dataclass
class Window:
    """One traced window.

    kernels: (name, start_us, end_us) of every device activity event;
    ranges:  the device-side spans of the benchmark's ranges, by name;
    host:    (start_us, end_us, name) of every host event, sorted by start;
    wall_s:  the window's host-clock length; requests, stacks: its work;
    least_s: the least time of that work (:mod:`..roofline`);
    engine:  the engine the program's ``auto`` picked;
    notes:   why a reader found nothing, for the run's log.
    """

    kernels: List[Tuple[str, float, float]]
    ranges: dict
    host: List[Tuple[float, float, str]]
    wall_s: float
    requests: int
    stacks: int
    least_s: float
    engine: str
    notes: list = dataclasses.field(default_factory=list)

    @property
    def busy_s(self) -> float:
        return union_us([(s, e) for _, s, e in self.kernels]) / 1e6

    def kernel_s(self, match) -> float:
        """Summed device time of the activity whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def inside_s(self, range_name: str) -> Optional[float]:
        """Device time of the activity that starts inside the device-side
        spans of ``range_name``; None when the range never appeared."""
        spans = sorted(self.ranges.get(range_name, []))
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0.0
        for _, s, e in self.kernels:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s < spans[i][1]:
                total += e - s
        return total / 1e6


def union_us(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def window(prof, wall_s: float, requests: int, stacks: int, least_s: float,
           engine: str) -> Window:
    """A :class:`Window` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    kernels, ranges, host = [], {}, []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(RANGE_PREFIX):
                ranges.setdefault(e.name, []).append((start, end))
            else:
                kernels.append((e.name, start, end))
        elif e.device_type == DeviceType.CPU:
            host.append((start, end, e.name))
    host.sort()
    return Window(kernels, ranges, host, wall_s, requests, stacks, least_s, engine)


def device_ops(w: Window, n: int = 10) -> list:
    """The ``n`` device operations that took most time: [name, seconds]."""
    by = {}
    for name, s, e in w.kernels:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(w: Window, n: int = 10) -> list:
    """The device's idle time inside the window's requests, summed by what
    the host was doing (the innermost host event over the middle of each
    gap): the ``n`` largest, [name, seconds]."""
    bounds = [(s, e) for s, e, name in w.host if name == REQUEST_RANGE]
    if not bounds or not w.kernels:
        return []
    lo, hi = min(s for s, _ in bounds), max(e for _, e in bounds)
    merged = []
    for s, e in sorted((s, e) for _, s, e in w.kernels):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    starts = [s for s, _, _ in w.host]
    by = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        name = "host outside any traced op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 4096, -1), -1):
            if w.host[j][1] >= mid:
                name = w.host[j][2]
                break
        by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
