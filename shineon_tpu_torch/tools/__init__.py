"""Entry points of the port's tools (run with ``python -m``), and what the
measurement tools share: the card's line, the device guard of their command
lines, the serving kernels' launch counters (kept in
``shineon_tpu_torch.tracing``) and device time by torch.profiler."""

from __future__ import annotations

import functools
import shutil
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

_FROM_TRACING = ("serving_counters", "launch_counts")


def __getattr__(name: str):
    """``serving_counters`` and ``launch_counts``, whose home is
    shineon_tpu_torch/tracing.py, imported on first use: chip_smoke.py loads
    this file by its path beside another checkout's package."""
    if name in _FROM_TRACING:
        from shineon_tpu_torch import tracing

        return getattr(tracing, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def card_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them; None
    where there is no nvidia-smi (a host without a card)."""
    if shutil.which("nvidia-smi") is None:
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def device_or_exit(device: str, prog: str):
    """A command line's device: the card unless ``--device cpu``; a card
    asked for on a host without CUDA ends the program with status 1."""
    import torch

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device (pass --device cpu to run on the CPU)", file=sys.stderr)
        raise SystemExit(1)
    return torch.device(device)


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@functools.lru_cache(maxsize=1)
def marker_names() -> frozenset:
    """The device events of torch.cuda._sleep(0) (a one-thread kernel), the
    default call marker of :func:`traced_calls`, read from a trace of a few
    calls."""
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


def traced_calls(fn, reps: int, marker: Optional[Callable] = None,
                 owns: Optional[Callable] = None, extra: Optional[int] = None) -> tuple:
    """The device events of the last ``reps`` of ``reps + extra`` calls of
    ``fn`` (``extra`` by default max(reps, 16)) in one torch.profiler trace
    (device activity only), begun after a 50 ms pause: each call is
    preceded by ``marker()`` (by default torch.cuda._sleep(0)), whose device
    events (``owns(name)``; by default :func:`marker_names`) cut the trace's
    events, in time order, into calls. In a long process the profiler drops
    the first events of a session (a full run's traces kept the last 14 of
    20 calls; deep into the run, 4 of 10), so the calls counted are the
    last ones, each found by its own marker. Returns ([[event, ...] a call],
    host ms a call over the traced window, to a synchronize)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if marker is None:
        marker, owns = (lambda: torch.cuda._sleep(0)), marker_names().__contains__
    extra = max(reps, 16) if extra is None else extra
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        t0 = time.perf_counter()
        for _ in range(reps + extra):
            marker()
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (reps + extra)
    events = sorted((e for e in prof.events() if e.device_type.name == "CUDA"),
                    key=lambda e: e.time_range.start)
    calls = []
    for e in events:
        if owns(e.name):
            calls.append([])
        elif calls:
            calls[-1].append(e)
    return calls[-reps:], wall_ms


def call_means(calls, reps: int, groups: Dict[str, Optional[tuple]]) -> Optional[dict]:
    """{group: mean device ms a call} over ``calls`` (:func:`traced_calls`),
    each group the summed duration of the events whose name holds one of
    its names (None: every event of the call), or None where the trace is
    short: fewer than ``reps`` calls, or a group whose kernel count differs
    between calls or is 0 in them."""
    if len(calls) < reps:
        return None
    out = {}
    for group, names in groups.items():
        picked = [[e.time_range.elapsed_us() for e in c
                   if names is None or any(n in e.name for n in names)] for c in calls]
        counts = {len(p) for p in picked}
        if len(counts) != 1 or 0 in counts:
            return None
        out[group] = sum(map(sum, picked)) / 1e3 / len(calls)
    return out


def op_means(calls) -> Dict[str, tuple]:
    """{kernel name: (mean device ms, mean launches) a call} over ``calls``
    (:func:`traced_calls`)."""
    ops: Dict[str, list] = {}
    for call in calls:
        for e in call:
            op = ops.setdefault(e.name, [0.0, 0])
            op[0] += e.time_range.elapsed_us() / 1e3
            op[1] += 1
    return {name: (ms / len(calls), n / len(calls)) for name, (ms, n) in ops.items()}


def device_times(fn, groups: Dict[str, Optional[tuple]], reps: int = 5,
                 marker: Optional[Callable] = None, owns: Optional[Callable] = None,
                 extra: Optional[int] = None, ops: bool = False) -> dict:
    """Device ms a call of ``fn`` for each group of kernel names (the
    summed time of the kernels whose name holds one of them; None: every
    kernel), the mean over the last ``reps`` marked calls of a trace taken
    after a warm-up call (:func:`traced_calls`, with its ``marker``,
    ``owns`` and ``extra``), under "wall" the host ms a call of the traced
    window, and with ``ops`` under "ops" each kernel's device ms and
    launches a call over the same calls (:func:`op_means`). The sums divide
    by the calls the trace holds, each found by its marker: a sum over a
    whole trace over ``reps`` reads low where the profiler dropped a
    session's first events. A trace whose marked calls are fewer than
    ``reps``, or in which a group has no kernel or a kernel count that
    differs between calls, is taken again, up to five times in all."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, 6):
        calls, wall_ms = traced_calls(fn, reps, marker, owns, extra)
        times = call_means(calls, reps, groups)
        if times is not None:
            return {**times, "wall": wall_ms, **({"ops": op_means(calls)} if ops else {})}
        print(f"the trace of {sorted(groups)} lost events: {len(calls)} marked calls "
              f"(attempt {attempt} of 5)", file=sys.stderr, flush=True)
    raise RuntimeError(f"the profiler lost events of {sorted(groups)} five times")
