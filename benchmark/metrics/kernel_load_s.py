"""kernel_load_s: the set-up's time building (nvcc, a checkout's first run)
and loading the hand-written kernels' libraries, s: the summed time of the
process's ``setup.kernel_load`` spans, which record whether or not spans
are on (shineon_tpu_torch/tracing.py::totals). None where the program
records no such span. Layer: kernels (csrc/fused_multispade.cu SPADE
chains)."""

NAME = "setup.kernel_load"


def read(ctx):
    try:
        from shineon_tpu_torch import tracing
    except ImportError:
        return None
    count, ns = tracing.totals().get(NAME, (0, 0))
    return ns / 1e9 if count else None
