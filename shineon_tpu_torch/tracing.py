"""The port's tracing: spans of host time where the work happens, and the
serving kernels' launch counters.

Spans
=====

``with tracing.span(name):`` times a stretch of host work. A recorded
:class:`Span` holds its name, its start and end on the
``time.perf_counter_ns()`` clock, its parent (the span open around it) and
its request: the sequence number of the ``serving.one_clip`` call it ran
in (:func:`request` opens that call's span and counts the call whether or
not spans record). Spans are kept in memory, the last :data:`MAX_SPANS`
in a ring (:func:`spans`), with a count and a total a name
(:func:`totals`) over everything recorded; :func:`reset` clears both.

When spans record:

* off by default: :func:`span` then checks two flags and returns one
  shared no-op context;
* while a torch.profiler session records (``torch.autograd.profiler.
  _is_profiler_enabled``), so ``bench --profile``, ``SHINEON_TRACE_DIR``
  and any profiled stretch get them. In a session each span also opens a
  ``torch._C._profiler._RecordFunctionFast`` range: a host event on the
  profiler's clock that names the stretch in its trace. Never
  ``torch.profiler.record_function``: a user annotation, which adds
  device-side ``gpu_user_annotation`` events on the card;
* for the whole process when the environment sets ``SHINEON_SPANS=<path>``
  (or after :func:`enable`): at exit the spans are written to that path as
  Chrome trace events (``ph: "X"``, ``ts`` in epoch µs), to load beside a
  profiler trace;
* always, for the once-a-process set-up spans of :func:`setup`, which are
  not on a hand-in's path.

The spans of the port, each covering the work named:

==================== ======================================================
``serving.one_clip`` a hand-in's host side (serving.make_one_clip); starts
                     its request
``serving.features`` device preprocessing (``SamsModel.features``)
``serving.gmm_warp`` GMM, TPS grid, grid-sample, the cloth spliced in
``serving.gen_scan`` the frame loop (``serving.gen_scan``)
``sams.frame``       one frame of ``SamsModel.generate_n_frames``:
                     generator, flow composite, the window's concatenation
``sams.resblock``    one ``AnySpadeResBlock.forward``
``spade.chain``      one SPADE site (``networks/sams/spade.py::fused_chain``)
``int8.conv3x3``     the int8 conv's quantize pass and launch (the card)
``setup.kernel_load`` a kernel library's nvcc build (first use in a
                     checkout) and load (``ops/cuda_build.load_library``)
``setup.warm_up``    the warm-up rollouts (``serving.warm_up``)
==================== ======================================================

Spans are opened and closed by one thread at a time (the one that runs the
clip or the training step); their nesting is that thread's.

Counters
========

The hand-written kernels' wrappers count their launches in attributes
(``fused_multispade_modulate.launches`` and the others):
:func:`serving_counters` names each, :func:`launch_counts` reads them.
Beside them, and read the same way, the SPADE sites' launch plans and
segmap operands at eval on the card
(``networks/sams/spade.py::fused_chain``, :data:`PLAN_COUNTERS`):

================= =====================================================
``plan_builds``   a site's launch plan made: its first call, or a
                  parameter, running statistic or x's shape changed
``plan_hits``     a site launched from its kept plan (after warm-up: every
                  site of a hand-in, 150 at the serving clip)
``segmap_builds`` a segmap operand made for a frame's labelmaps at one
                  resolution (9 a frame at the serving clip)
``segmap_hits``   a site that took a segmap operand already made
================= =====================================================

A chain with an instance norm, the CPU and autograd take neither plan nor
memo and count none of the four.
"""

from __future__ import annotations

import atexit
import collections
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

ENV = "SHINEON_SPANS"
MAX_SPANS = 1 << 18  # spans kept; about 330 a serving hand-in


class Span(NamedTuple):
    id: int  # from 1, in the order spans open
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    parent: int  # id of the span open around it; 0 at the top
    request: int  # serving.one_clip calls begun when it opened: its hand-in (0: none)


_clock = time.perf_counter_ns
_on = False  # spans record for the whole process
_path: Optional[str] = None
_offset_ns: Optional[int] = None  # time.time_ns() - _clock(), when spans first recorded
_ring: collections.deque = collections.deque(maxlen=MAX_SPANS)
_totals: Dict[str, list] = {}
_open = None  # the innermost open span
_last_id = 0
_request = 0


class _Off:
    """The shared context of a span that does not record."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A recording span; :class:`Span` once closed."""

    __slots__ = ("name", "id", "outer", "request", "start", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _open, _last_id, _offset_ns
        if _offset_ns is None:
            _offset_ns = time.time_ns() - _clock()
        _last_id += 1
        self.id, self.outer, self.request = _last_id, _open, _request
        _open = self
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _RecordFunctionFast(self.name)
            self.range.__enter__()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        global _open
        end = _clock()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open = self.outer
        s = Span(self.id, self.name, self.start, end, self.outer.id if self.outer else 0,
                 self.request)
        _ring.append(s)
        total = _totals.get(s.name)
        if total is None:
            _totals[s.name] = [1, end - self.start]
        else:
            total[0] += 1
            total[1] += end - self.start
        return False


def span(name: str):
    """A context that records span ``name`` while spans record (see the
    module's docstring), else the shared no-op context."""
    if _on or _profiler._is_profiler_enabled:
        return _Open(name)
    return _OFF


def request():
    """A hand-in's outermost span, ``serving.one_clip``: counts the call
    (its request id, shared by every span inside it), then as :func:`span`."""
    global _request
    _request += 1
    return span("serving.one_clip")


def setup(name: str):
    """A once-a-process set-up span: records whether or not spans are on."""
    return _Open(name)


def spans() -> List[Span]:
    """The recorded spans in the ring, in the order they closed."""
    return list(_ring)


def totals() -> Dict[str, tuple]:
    """{name: (count, total ns)} over every span recorded since the last
    :func:`reset`, including those the ring no longer holds."""
    return {name: (c, ns) for name, (c, ns) in _totals.items()}


def reset() -> None:
    """Forget the recorded spans and their totals."""
    _ring.clear()
    _totals.clear()


def enable(path: Optional[str] = None) -> None:
    """Record spans for the whole process from now; with ``path``, write
    them there as a Chrome trace at exit (:func:`write_chrome_trace`)."""
    global _on, _path, _offset_ns
    _on = True
    _offset_ns = time.time_ns() - _clock()
    _path = path or _path


def write_chrome_trace(path: Optional[str]) -> None:
    """Write the recorded spans to ``path`` (nothing without a path) as
    Chrome trace events: complete events (``ph: "X"``) with ``ts`` and
    ``dur`` in µs, ``ts`` on the epoch clock (``time.time_ns()``, as
    torch.profiler's traces), and each span's id, parent and request under
    ``args``."""
    if not path:
        return
    offset = _offset_ns if _offset_ns is not None else time.time_ns() - _clock()
    pid = os.getpid()
    events = [{"name": s.name, "cat": "span", "ph": "X", "pid": pid, "tid": pid,
               "ts": (s.start_ns + offset) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"id": s.id, "parent": s.parent, "request": s.request}}
              for s in _ring]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


PLAN_COUNTERS = ("plan_builds", "plan_hits", "segmap_builds", "segmap_hits")


def serving_counters() -> Dict[str, tuple]:
    """Every serving kernel's launch counter as (wrapper, attribute):
    kernel 1 (the full-precision chain), kernel 2 and its pre-pass, kernel
    4 and its quantize pass, kernel 3 (attention); then the SPADE sites'
    :data:`PLAN_COUNTERS` on ``fused_chain``."""
    from shineon_tpu_torch.networks.sams import spade
    from shineon_tpu_torch.ops import fused_attention, fused_spade, int8_conv

    fmm = fused_spade.fused_multispade_modulate
    return {"fused_multispade": (fmm, "launches"),
            "fused_multispade_int8": (fmm, "int8_launches"),
            "multispade_hidden_absmax": (fmm, "absmax_launches"),
            "int8_conv3x3": (int8_conv.conv3x3_int8, "launches"),
            "int8_quantize": (int8_conv.quantize_int8, "launches"),
            "sagan_attention": (fused_attention.sagan_attention, "launches"),
            **{name: (spade.fused_chain, name) for name in PLAN_COUNTERS}}


def launch_counts() -> Dict[str, int]:
    """Every serving kernel's launch count and the plan counters now
    (:func:`serving_counters`)."""
    return {n: getattr(owner, attr) for n, (owner, attr) in serving_counters().items()}


atexit.register(lambda: write_chrome_trace(_path))
if os.environ.get(ENV):
    enable(os.environ[ENV])
