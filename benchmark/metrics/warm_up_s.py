"""warm_up_s: the set-up's time in the warm-up rollouts (serving.warm_up), s:
the summed time of the process's ``setup.warm_up`` spans, which record
whether or not spans are on (shineon_tpu_torch/tracing.py::totals). None
where the program records no such span. Layer: entry (serving.py,
one_clip's host side)."""

NAME = "setup.warm_up"


def read(ctx):
    try:
        from shineon_tpu_torch import tracing
    except ImportError:
        return None
    count, ns = tracing.totals().get(NAME, (0, 0))
    return ns / 1e9 if count else None
