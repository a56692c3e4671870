"""host_ms.one_clip.offline: the host's time inside serving.one_clip, ms, in
the cells that report frames_per_s: as host_ms.one_clip.sync.py reads it.
Layer: entry (serving.py, one_clip's host side)."""

from pathlib import Path

from benchmark import registry

_spans = registry.metric("host_ms.one_clip.sync", Path(__file__).resolve().parents[1])


def read(ctx):
    return _spans.host_ms(ctx, "serving.one_clip")
