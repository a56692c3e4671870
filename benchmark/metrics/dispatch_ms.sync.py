"""dispatch_ms.sync: the host's time in one_clip, ms: from the hand-in until
the call returns (before the output is awaited), the mean over the
window's hand-ins outside the traced stretch (whose host side the profiler
slows). Layer: entry (serving.py, one_clip's host side)."""


def read(ctx):
    d = [c.returned - c.handed for c in ctx.window.clips if not c.traced]
    return 1e3 * sum(d) / len(d) if d else None
