"""SAGAN self-attention block, NHWC (counterpart of
shineon_tpu/networks/attention.py; reference models/networks/attention/sagan.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.ops.fused_attention import sagan_attention

# the JAX package initialises the three 1x1 convs N(0, 0.02)
# (kernel_init_for("normal", 0.02)), biases zero and gamma zero
INIT_STD = 0.02


class SelfAttention(nn.Module):
    """out = gamma * softmax(Q K^T) V + x over the H*W tokens, with Q and K
    at C/8 channels and V at C. gamma starts at 0, so a freshly initialised
    block is the identity. The 1x1 convs run in the compute dtype; the
    attention is :func:`sagan_attention` (the hand-written kernel on the
    card)."""

    def __init__(self, channels: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.query_conv = Conv2d(channels, channels // 8, 1, dtype=dtype)
        self.key_conv = Conv2d(channels, channels // 8, 1, dtype=dtype)
        self.value_conv = Conv2d(channels, channels, 1, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def convs(self):
        return self.query_conv, self.key_conv, self.value_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        n = H * W
        q = self.query_conv(x).reshape(B, n, C // 8)
        k = self.key_conv(x).reshape(B, n, C // 8)
        v = self.value_conv(x).reshape(B, n, C)
        out = sagan_attention(q, k, v).reshape(B, H, W, C).to(x.dtype)
        # gamma is an f32 (1,) parameter: like the JAX module, the sum comes
        # out in f32 for a bf16 x
        return self.gamma * out + x
