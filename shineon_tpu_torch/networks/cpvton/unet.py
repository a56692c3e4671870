"""Recursive skip-connection U-Net generator, NHWC (counterpart of
shineon_tpu/networks/cpvton/unet.py; reference models/networks/cpvton/unet.py).

A level is down = [act (not outermost), conv k4 s2 p1, norm (neither
outermost nor innermost), down_attn?], then its submodule, then up = [act,
bilinear 2x, conv k3 s1 p1, norm, up_attn?]; every level but the outermost
returns cat([x, up], channels). Self-attention goes into the levels from
the innermost outward while the ``num_attention`` budget lasts. The nesting
(``model.submodule.submodule...``, ``downconv``, ``upconv``, ``down_attn``,
``up_attn``) is the flax tree's, so its variables load without renames.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shineon_tpu_torch.networks.activation import get_activation_fn, leaky_relu
from shineon_tpu_torch.networks.attention import SelfAttention
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.normalization import instance_norm


def upsample_bilinear_2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of NHWC ``x``, half-pixel centres: the JAX
    package's ``jax.image.resize(..., "linear")``, which at 2x is
    ``F.interpolate(align_corners=False)`` (the edge rows and columns repeat
    the edge pixel in both). Computed in x's dtype."""
    out = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)


class UnetSkipConnectionBlock(nn.Module):
    """One U-Net level. Only the instance norm (no affine, convs with
    biases) is ported: TOM's U-Net is the only one the models build, and
    its norm is ``instance``; dropout is off there too."""

    def __init__(self, outer_nc: int, inner_nc: int, input_nc: Optional[int] = None,
                 submodule: Optional[nn.Module] = None, outermost: bool = False,
                 innermost: bool = False, norm: str = "instance", self_attn: bool = False,
                 use_dropout: bool = False, activation: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if norm != "instance" or use_dropout:
            raise NotImplementedError("the U-Net takes norm='instance' without dropout only")
        self.outermost, self.innermost, self.dtype = outermost, innermost, dtype
        input_nc = outer_nc if input_nc is None else input_nc
        if activation is None:
            self.down_act, self.up_act = (lambda h: leaky_relu(h, 0.2)), F.relu
        else:
            self.down_act = self.up_act = get_activation_fn(activation)
        self.downconv = Conv2d(input_nc, inner_nc, 4, stride=2, padding=1, dtype=dtype)
        self.down_attn = SelfAttention(inner_nc, dtype=dtype) if self_attn else None
        self.submodule = submodule
        up_in = inner_nc if innermost else 2 * inner_nc
        self.upconv = Conv2d(up_in, outer_nc, 3, padding=1, dtype=dtype)
        self.up_attn = SelfAttention(outer_nc, dtype=dtype) if self_attn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x if self.outermost else self.down_act(x)
        h = self.downconv(h)
        if not self.outermost and not self.innermost:
            h = instance_norm(h, dtype=self.dtype)
        if self.down_attn is not None:
            h = self.down_attn(h)
        if self.submodule is not None:
            h = self.submodule(h)
        h = upsample_bilinear_2x(self.up_act(h))
        h = instance_norm(self.upconv(h), dtype=self.dtype)
        if self.up_attn is not None:
            h = self.up_attn(h)
        if self.outermost:
            return h
        return torch.cat([x, h], dim=-1)  # promotes, as jnp.concatenate


class UnetGenerator(nn.Module):
    """U-Net of ``num_downs`` levels (reference unet.py:9-100): the
    innermost at ngf*8, ``num_downs - 5`` more at ngf*8, then ngf*(4, 8),
    (2, 4), (1, 2) and the outermost (output_nc, ngf) on ``input_nc``."""

    def __init__(self, input_nc: int, output_nc: int, num_downs: int,
                 num_attention: int = 0, ngf: int = 64, norm: str = "instance",
                 use_self_attn: bool = False, activation: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        budget = num_attention if use_self_attn else 0
        kw = dict(norm=norm, activation=activation, dtype=dtype)

        def attn():
            nonlocal budget
            budget -= 1
            return budget >= 0

        block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, innermost=True, self_attn=attn(), **kw)
        for _ in range(num_downs - 5):
            block = UnetSkipConnectionBlock(ngf * 8, ngf * 8, submodule=block,
                                            self_attn=attn(), **kw)
        for mult_outer, mult_inner in ((4, 8), (2, 4), (1, 2)):
            block = UnetSkipConnectionBlock(ngf * mult_outer, ngf * mult_inner,
                                            submodule=block, self_attn=attn(), **kw)
        self.model = UnetSkipConnectionBlock(output_nc, ngf, input_nc=input_nc, submodule=block,
                                             outermost=True, self_attn=attn(), **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x)
