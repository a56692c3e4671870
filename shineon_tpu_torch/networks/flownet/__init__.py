"""FlowNet2 (counterpart of shineon_tpu/networks/flownet)."""

from shineon_tpu_torch.networks.flownet.flownet2 import (  # noqa: F401
    FlowNet2,
    FlowNetC,
    FlowNetFusion,
    FlowNetS,
    FlowNetSD,
)
