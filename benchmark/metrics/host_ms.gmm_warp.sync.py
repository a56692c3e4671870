"""host_ms.gmm_warp.sync: the host's time in the GMM warp (GMM, TPS grid,
grid-sample, cloth splice), ms: the mean over the first half of the traced
hand-ins of the summed host time of their ``serving.gmm_warp`` spans
(host_ms.one_clip.sync.py::host_ms). Layer: models (SamsModel, the whole
clip)."""

from pathlib import Path

from benchmark import registry

_spans = registry.metric("host_ms.one_clip.sync", Path(__file__).resolve().parents[1])


def read(ctx):
    return _spans.host_ms(ctx, "serving.gmm_warp")
