"""MultiSpade: one SPADE per labelmap, applied in sorted key order
(counterpart of shineon_tpu/networks/sams/multispade.py)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from shineon_tpu_torch.networks.activation import get_activation_fn
from shineon_tpu_torch.networks.layers import compute_dtype, conv2d_nhwc
from shineon_tpu_torch.networks.sams.spade import (
    SPADE,
    fused_chain,
    parse_spade_config,
    resize_nearest,
)


class MultiSpade(nn.Module):
    """Sequential SPADEs over the labelmaps, keys sorted alphabetically.

    At eval with running-statistics norms the whole L-label chain is ONE
    kernel launch; with instance norm (statistics of the intermediate chain
    value) it is one launch a label. With ``int8`` those chains are
    quantized. In training the labels' mlp_shared convs run as one
    block-diagonal conv and each SPADE applies in turn.
    """

    def __init__(self, norm_nc: int, label_channels: Dict[str, int],
                 config_text: str = "spadeinstance3x3", activation: str = "relu",
                 dtype: Optional[torch.dtype] = None, int8: bool = False):
        super().__init__()
        self.keys = sorted(label_channels)
        self.norm_type, self.ks = parse_spade_config(config_text)
        self.activation, self.dtype = activation, dtype
        for key in self.keys:
            self.add_module(f"spade_{key}", SPADE(
                norm_nc, label_channels[key], config_text=config_text,
                activation=activation, dtype=dtype, int8=int8,
            ))

    def spades(self):
        return [getattr(self, f"spade_{key}") for key in self.keys]

    def shared_hiddens(self, x, labelmaps: Dict[str, torch.Tensor]):
        """Training: every label's hidden map from ONE block-diagonal conv
        (they depend only on the segmaps; zero blocks add exact zeros), or
        None a label where that does not apply."""
        spades = self.spades()
        if self.ks != 3 or len(spades) == 1:
            return [None] * len(spades)
        segs = [resize_nearest(labelmaps[k], x.shape[-3], x.shape[-2]).to(x.dtype)
                for k in self.keys]
        cs = [s.shape[-1] for s in segs]
        total, off, blocks = sum(cs), 0, []
        for s, c in zip(spades, cs):
            blocks.append(F.pad(s.mlp_shared.weight, (0, 0, 0, 0, off, total - off - c)))
            off += c
        w_bd = torch.cat(blocks, dim=0)
        b_cat = torch.cat([s.mlp_shared.bias for s in spades])
        h_all = get_activation_fn(self.activation)(conv2d_nhwc(
            torch.cat(segs, dim=-1), w_bd, b_cat, compute_dtype(self.dtype), padding=1,
        ))
        nh = spades[0].mlp_shared.weight.shape[0]
        return [h_all[..., i * nh:(i + 1) * nh] for i in range(len(spades))]

    def forward(self, x, labelmaps: Dict[str, torch.Tensor], train: bool = True):
        spades = self.spades()
        if not train and self.ks == 3:
            if self.norm_type == "instance":
                for spade, key in zip(spades, self.keys):
                    x = spade.forward_fused(x, labelmaps[key])
                return x
            return fused_chain(spades, x, [labelmaps[k] for k in self.keys])

        for spade, key, h in zip(spades, self.keys, self.shared_hiddens(x, labelmaps)):
            x = spade(x, labelmaps[key], train=train, hidden=h)
        return x
