"""host_ms.int8_conv.sync: the host's time in the int8 convs' wrappers
(quantize pass and launch, ops/int8_conv.py), ms: the mean over the first
half of the traced hand-ins of the summed host time of their
``int8.conv3x3`` spans (host_ms.one_clip.sync.py::host_ms). Layer: ops
(every CUDA kernel a clip launches)."""

from pathlib import Path

from benchmark import registry

_spans = registry.metric("host_ms.one_clip.sync", Path(__file__).resolve().parents[1])


def read(ctx):
    return _spans.host_ms(ctx, "int8.conv3x3")
