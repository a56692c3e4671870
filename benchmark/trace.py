"""The traced stretch of a ``--trace 1`` run and its reduction.

A few hand-ins of a steady stretch of the window run under torch.profiler
(host and device activity), each preceded by a marker kernel
(``torch.cuda._sleep(0)``) whose device events cut the trace's device
events, in time order, into clips: late in a long process the profiler can
drop a session's first events, so only clips that begin with their own
marker are counted, and of three or more the first is left out (events
can be lost up to a point inside it). The reduction keeps plain tuples, so that the per-layer
readers and the tests need no profiler:

* ``clips``: [[(name, start_us, end_us), ...] a marked clip] of device events;
* ``host``: [(name, start_us, end_us)] of host events;
* ``window``: (start_us, end_us): from the first counted clip's marker to
  the end of the last device event.
"""

from __future__ import annotations

import bisect
import functools
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

Event = Tuple[str, float, float]
SCAN = 4000  # host events looked back at for a gap's label


@functools.lru_cache(maxsize=1)
def marker_names() -> frozenset:
    """The device event names of torch.cuda._sleep(0), read from a trace of
    a few calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
        names = frozenset(e.name for e in prof.events() if e.device_type.name == "CUDA")
        if names:
            return names
    raise RuntimeError("the profiler shows no event of torch.cuda._sleep")


@dataclass
class Trace:
    clips: List[List[Event]] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def device_events(self) -> List[Event]:
        return [e for c in self.clips for e in c]


def reduce(device: List[Event], host: List[Event], markers) -> Trace:
    """Cut time-ordered device events into marked clips (``markers``: a
    predicate on an event name)."""
    device = sorted(device, key=lambda e: e[1])
    clips, starts = [], []
    for e in device:
        if markers(e[0]):
            clips.append([])
            starts.append(e[1])
        elif clips:
            clips[-1].append(e)
    if len(clips) > 2:
        clips, starts = clips[1:], starts[1:]
    if not clips or not any(clips):
        return Trace()
    end = max(e[2] for c in clips for e in c)
    return Trace(clips=clips, host=sorted(host, key=lambda e: e[1]), window=(starts[0], end))


def busy_intervals(events: List[Event], window: Tuple[float, float]) -> List[Tuple[float, float]]:
    """The union of the events' intervals, clipped to the window."""
    out: List[List[float]] = []
    for _, s, e in sorted(events, key=lambda e: e[1]):
        s, e = max(s, window[0]), min(e, window[1])
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(tr: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(tr.device_events(), tr.window)) / 1e6


def idle_percent(tr: Trace):
    """The share of the traced window in which no operation ran on the
    device, %: 100 * (1 - union of device intervals / window); None
    without a window."""
    return 100.0 * (1.0 - busy_s(tr) / tr.window_s) if tr.window_s > 0 else None


def is_kernel(name: str) -> bool:
    """A device kernel, not a copy or a fill of the copy engines."""
    return not name.startswith(("Memcpy", "Memset"))


def top_ops(tr: Trace, k: int = 10) -> List[list]:
    """[[name, seconds a clip]] of the device operations that took most
    time, over the marked clips."""
    tot = {}
    for e in tr.device_events():
        tot[e[0]] = tot.get(e[0], 0.0) + (e[2] - e[1]) / 1e6
    n = max(len(tr.clips), 1)
    return [[name[:160], s / n] for name, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(tr: Trace, k: int = 10) -> List[list]:
    """[[host activity, idle seconds a clip]]: every gap between device
    activity inside the window, labelled by the innermost host event
    running at its midpoint ("host: between ops" where none is), summed by label;
    the labels with the most idle time."""
    busy = busy_intervals(tr.device_events(), tr.window)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    tot = {}
    host = tr.host
    starts = [h[1] for h in host]
    for s, e in gaps:
        mid = (s + e) / 2
        label = "host: between ops"
        # in a nested call tree the covering event that began last is the innermost
        last = bisect.bisect_right(starts, mid) - 1
        for j in range(last, max(last - SCAN, -1), -1):
            if host[j][2] >= mid:
                label = host[j][0][:160]
                break
        tot[label] = tot.get(label, 0.0) + (e - s) / 1e6
    n = max(len(tr.clips), 1)
    return [[name, s / n] for name, s in sorted(tot.items(), key=lambda x: -x[1])[:k]]


class Profiled:
    """The window's traced stretches (see window.run), once ``due`` (a third
    of the window gone): ``per_stretch`` marked hand-ins under
    torch.profiler with device activity alone, which the per-layer metrics
    read; then as many with host activity too, whose host events label the
    idle gaps of the breakdown (recording every host op slows the host, so
    that stretch's idle share is not the run's)."""

    def __init__(self, seconds: float, per_stretch: int):
        self.seconds, self.per_stretch = seconds, per_stretch
        self.count = 2 * per_stretch
        self.profs = []
        self.marks = 0
        self.result: Optional[Trace] = None
        self.labelled: Optional[Trace] = None
        self.reduce_s = 0.0

    def due(self, elapsed: float) -> bool:
        return elapsed >= self.seconds / 3

    def _start(self, host: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
        self.profs.append(profile(activities=acts))
        self.profs[-1].__enter__()

    def _stop(self):
        import torch

        torch.cuda.synchronize()
        self.profs[-1].__exit__(None, None, None)

    def begin(self):
        marker_names()
        self._start(host=False)

    def mark(self):
        import torch

        if self.marks == self.per_stretch:
            self._stop()
            self._start(host=True)
        self.marks += 1
        torch.cuda._sleep(0)

    def end(self):
        self._stop()

    def collect(self) -> Trace:
        """Reduce the profiles (after the window: it takes seconds); the
        device-only stretch's trace, the labelled one in ``labelled``."""
        t0 = time.perf_counter()
        names = marker_names()
        traces = []
        for prof in self.profs:
            dev, host = [], []
            for e in prof.events():
                ev = (e.name, float(e.time_range.start), float(e.time_range.end))
                (dev if e.device_type.name == "CUDA" else host).append(ev)
            traces.append(reduce(dev, host, names.__contains__))
        self.profs = []
        self.result, self.labelled = traces[0], traces[-1]
        self.reduce_s = time.perf_counter() - t0
        return self.result
