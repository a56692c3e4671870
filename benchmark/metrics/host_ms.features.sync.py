"""host_ms.features.sync: the host's time in device preprocessing
(SamsModel.features), ms: the mean over the first half of the traced
hand-ins of the summed host time of their ``serving.features`` spans
(host_ms.one_clip.sync.py::host_ms). Layer: entry (serving.py, one_clip's
host side)."""

from pathlib import Path

from benchmark import registry

_spans = registry.metric("host_ms.one_clip.sync", Path(__file__).resolve().parents[1])


def read(ctx):
    return _spans.host_ms(ctx, "serving.features")
