"""device_idle.offline: the device's idle share of the traced window, %
(benchmark/trace.py::idle_percent), in the cells that report
frames_per_s. Layer: device."""

from benchmark.trace import idle_percent


def read(ctx):
    return idle_percent(ctx.trace)
