"""host_ms.one_clip.sync: the host's time inside serving.one_clip, ms, read
from the program's own spans (shineon_tpu_torch/tracing.py, on while the
profiler records): the mean, over the first half of the window's traced
hand-ins (the device-only stretch), of the summed inclusive time of a
hand-in's spans of one name. A span belongs to the hand-in whose
``serving.one_clip`` span (its request) began within the hand-in's [handed,
returned] on the window's clock (time.perf_counter, the spans' clock). None
where the program records no spans. The other ``host_ms`` readers call
:func:`host_ms` with their span's name. Layer: entry (serving.py,
one_clip's host side)."""

ROOT = "serving.one_clip"


def recorded():
    """The program's recorded spans, or None where it has no spans."""
    try:
        from shineon_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def host_ms(ctx, name: str):
    spans = recorded()
    if not spans:
        return None
    traced = [c for c in ctx.window.clips if c.traced]
    roots = [s for s in spans if s.name == ROOT]
    per_clip = []
    for c in traced[:len(traced) // 2]:
        lo, hi = c.handed * 1e9, c.returned * 1e9
        requests = {s.request for s in roots if lo <= s.start_ns <= hi}
        if requests:
            per_clip.append(sum(s.end_ns - s.start_ns for s in spans
                                if s.name == name and s.request in requests))
    return sum(per_clip) / len(per_clip) / 1e6 if per_clip else None


def read(ctx):
    return host_ms(ctx, ROOT)
