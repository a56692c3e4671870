"""device_idle.sync: the device's idle share of the traced window, %
(benchmark/trace.py::idle_percent), in the cells that report
clip_p90_ms. Layer: device."""

from benchmark.trace import idle_percent


def read(ctx):
    return idle_percent(ctx.trace)
