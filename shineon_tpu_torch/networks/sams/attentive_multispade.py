"""AttentiveMultiSpade: parallel SPADEs -> channel concat -> SAGAN attention ->
3x3 conv back to C -> leaky_relu (counterpart of
shineon_tpu/networks/sams/attentive_multispade.py)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from shineon_tpu_torch.networks.activation import leaky_relu
from shineon_tpu_torch.networks.attention import SelfAttention
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.sams.multispade import MultiSpade


class AttentiveMultiSpade(MultiSpade):
    """Every label's SPADE modulates the SAME x (not in turn, as in
    MultiSpade); their outputs are concatenated in sorted key order (L*C
    channels), attended over, and mapped back to C channels by
    ``mlp_final``, a plain 3x3 conv in the compute dtype (never int8, as in
    the JAX package), then leaky_relu(0.01).

    At eval each label is a one-label fused chain (quantized when built with
    ``int8``): L chain launches and one attention launch a call. In training
    the labels' hidden maps come from one block-diagonal conv, as in
    MultiSpade.
    """

    def __init__(self, norm_nc: int, label_channels: Dict[str, int],
                 config_text: str = "spadeinstance3x3", activation: str = "relu",
                 dtype: Optional[torch.dtype] = None, int8: bool = False):
        super().__init__(norm_nc, label_channels, config_text=config_text,
                         activation=activation, dtype=dtype, int8=int8)
        together = len(self.keys) * norm_nc
        self.attention_layer = SelfAttention(together, dtype=dtype)
        self.mlp_final = Conv2d(together, norm_nc, self.ks, padding=self.ks // 2, dtype=dtype)

    def forward(self, x, labelmaps: Dict[str, torch.Tensor], train: bool = True):
        spades = self.spades()
        if not train and self.ks == 3:
            outputs = [s.forward_fused(x, labelmaps[k]) for s, k in zip(spades, self.keys)]
        else:
            hiddens = self.shared_hiddens(x, labelmaps)
            outputs = [s(x, labelmaps[k], train=train, hidden=h)
                       for s, k, h in zip(spades, self.keys, hiddens)]
        attended = self.attention_layer(torch.cat(outputs, dim=-1))
        return leaky_relu(self.mlp_final(attended), 0.01)
