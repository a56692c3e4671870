"""The measured window: a closed loop of hand-ins, and the end-to-end
metrics taken from it by the host's clock.

The loop hands batch ``i`` to the system (``submit(i)``, which returns once
the system has taken the batch, with a handle whose ``wait()`` returns when
the batch's output is ready) while ``seconds`` have not run out, with at
most ``in_flight`` batches handed in and not finished: before the next
hand-in it waits for the oldest. The window runs from the first hand-in to
the completion of the last batch handed in.
"""

from __future__ import annotations

import statistics
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional


@dataclass
class Clip:
    index: int
    handed: float  # clock at hand-in
    returned: float  # clock when the call returned (host dispatch done)
    done: float = 0.0  # clock when its output was ready
    traced: bool = False


@dataclass
class Window:
    clips: List[Clip] = field(default_factory=list)
    start: float = 0.0
    end: float = 0.0

    @property
    def seconds(self) -> float:
        return self.end - self.start


def run(submit: Callable[[int], object], seconds: float, in_flight: int,
        clock: Callable[[], float] = time.perf_counter,
        trace: Optional[object] = None) -> Window:
    """Run the closed loop. ``trace``, when given, has ``due(elapsed)``,
    ``begin()``, ``count`` and ``end()``: once due, the loop drains, calls
    ``begin()``, marks and hands in ``count`` batches, drains and calls
    ``end()``; those batches are flagged ``traced``."""
    win = Window()
    pending = deque()

    def finish(entry):
        clip, handle = entry
        handle.wait()
        clip.done = clock()
        win.clips.append(clip)

    def drain():
        while pending:
            finish(pending.popleft())

    tracing_left = -1  # > 0 while a traced stretch runs
    i = 0
    win.start = clock()
    while True:
        now = clock()
        if now - win.start >= seconds and tracing_left <= 0:
            break
        if trace is not None and tracing_left < 0 and trace.due(now - win.start):
            drain()
            trace.begin()
            tracing_left = trace.count
        if tracing_left > 0:
            trace.mark()
        handed = clock()
        handle = submit(i)
        clip = Clip(i, handed, clock(), traced=tracing_left > 0)
        pending.append((clip, handle))
        if tracing_left > 0:
            tracing_left -= 1
            if tracing_left == 0:
                drain()
                trace.end()
        if len(pending) >= in_flight:
            finish(pending.popleft())
        i += 1
    drain()
    win.clips.sort(key=lambda c: c.index)
    win.end = max(c.done for c in win.clips)
    return win


def frames_per_s(win: Window, batch: int, frames: int) -> float:
    """Frames of every clip completed in the window over its seconds."""
    return len(win.clips) * batch * frames / win.seconds


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile (statistics.quantiles, inclusive method)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def clip_p90_ms(win: Window) -> float:
    """90th percentile over all clips of hand-in to output ready, ms."""
    return 1e3 * percentile([c.done - c.handed for c in win.clips], 90)
