"""host_ms.gen_scan.sync: the host's time in the frame loop
(serving.gen_scan), ms: the mean over the first half of the traced hand-ins
of the summed host time of their ``serving.gen_scan`` spans
(host_ms.one_clip.sync.py::host_ms). Layer: models (SamsModel, the whole
clip)."""

from pathlib import Path

from benchmark import registry

_spans = registry.metric("host_ms.one_clip.sync", Path(__file__).resolve().parents[1])


def read(ctx):
    return _spans.host_ms(ctx, "serving.gen_scan")
