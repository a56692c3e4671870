"""host_ms.spade_chain.sync: the host's time in the SPADE sites' chain
wrappers (networks/sams/spade.py::fused_chain), ms: the mean over the first
half of the traced hand-ins of the summed host time of their
``spade.chain`` spans (host_ms.one_clip.sync.py::host_ms). Layer: kernels
(csrc/fused_multispade.cu SPADE chains)."""

from pathlib import Path

from benchmark import registry

_spans = registry.metric("host_ms.one_clip.sync", Path(__file__).resolve().parents[1])


def read(ctx):
    return _spans.host_ms(ctx, "spade.chain")
