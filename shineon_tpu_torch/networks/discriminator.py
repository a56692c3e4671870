"""PatchGAN discriminators, NHWC (counterpart of
shineon_tpu/networks/discriminator.py; reference discriminator.py:16-145).

NLayerDiscriminator: a pyramid of k4 pad-2 convs with LeakyReLU(0.2), the
norm from a ``spectral``-prefixed config string (default
``spectralinstance``; instance norm or none: the JAX package's batch-norm
variants, which no configuration uses, are not ported).
MultiscaleDiscriminator: ``num_D`` of them over an
average-pool pyramid (k3 s2, padding not counted). Both return the JAX
modules' nested feature lists.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from shineon_tpu_torch.networks.activation import leaky_relu
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.normalization import SpectralConv2d, instance_norm

KSIZE, PAD = 4, 2  # the reference's kw = 4, padw = ceil((4 - 1) / 2)


def avg_pool_no_pad_count(x: torch.Tensor) -> torch.Tensor:
    """``F.avg_pool2d(x, 3, stride=2, padding=1, count_include_pad=False)``
    on NHWC. The pool reads a contiguous NCHW copy: on a CUDA tensor with
    channels-last strides (an NHWC tensor's NCHW view) PyTorch 2.11's
    avg_pool2d backward is wrong (0.9 of the gradient's max off on an H100,
    either count_include_pad), its forward right."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, stride=2, padding=1,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)


class NLayerDiscriminator(nn.Module):
    """conv0 (stride 2) -> ``n_layers - 1`` normed convs (stride 2, the last
    stride 1; widths doubling to at most 512) -> conv_out (1 channel). The
    convs followed by a norm have no bias, unless the norm is none. Returns
    every layer's output, or the logits alone without
    ``get_intermediate_features``."""

    def __init__(self, in_channels: int, ndf: int = 64, n_layers: int = 4,
                 norm_D: str = "spectralinstance", get_intermediate_features: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.spectral = norm_D.startswith("spectral")
        self.subnorm = norm_D[len("spectral"):] if self.spectral else norm_D
        if self.subnorm not in ("none", "", "instance"):
            raise ValueError(f"unsupported norm_D: {norm_D}")
        self.get_intermediate_features, self.dtype = get_intermediate_features, dtype
        self.names = ["conv0"] + [f"conv{n}" for n in range(1, n_layers)] + ["conv_out"]
        nf, cin = ndf, in_channels
        self.add_module("conv0", self._conv(cin, nf, 2, normed=False))
        for n in range(1, n_layers):
            cin, nf = nf, min(nf * 2, 512)
            stride = 1 if n == n_layers - 1 else 2
            self.add_module(f"conv{n}", self._conv(cin, nf, stride, normed=True))
        self.add_module("conv_out", self._conv(nf, 1, 1, normed=False))

    def _conv(self, cin, cout, stride, normed):
        bias = not normed or self.subnorm in ("none", "")
        cls = SpectralConv2d if self.spectral else Conv2d
        return cls(cin, cout, KSIZE, padding=PAD, bias=bias, dtype=self.dtype, stride=stride)

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        """x (B, H, W, C); ``update_stats`` stores the spectral ``u`` and
        ``sigma`` of this call's power step."""
        results: List[torch.Tensor] = []
        h = x
        for i, name in enumerate(self.names):
            conv = getattr(self, name)
            h = conv(h, update_stats=update_stats) if self.spectral else conv(h)
            if name != "conv_out":
                if i > 0 and self.subnorm == "instance":
                    h = instance_norm(h, dtype=self.dtype)
                h = leaky_relu(h, 0.2)
            results.append(h)
        return results if self.get_intermediate_features else results[-1]


class MultiscaleDiscriminator(nn.Module):
    """``num_D`` NLayerDiscriminators (``discriminator_i``), each on the
    input average-pooled i times. Returns a list, one entry a scale: the
    feature list (or, without intermediate features, a one-element list
    of the logits)."""

    def __init__(self, in_channels: int, num_D: int = 2, ndf: int = 64, n_layers: int = 4,
                 norm_D: str = "spectralinstance", get_intermediate_features: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_D = num_D
        for i in range(num_D):
            self.add_module(f"discriminator_{i}", NLayerDiscriminator(
                in_channels, ndf, n_layers, norm_D, get_intermediate_features, dtype))

    def forward(self, x: torch.Tensor, update_stats: bool = False):
        results = []
        h = x
        for i in range(self.num_D):
            d = getattr(self, f"discriminator_{i}")
            out = d(h, update_stats=update_stats)
            results.append(out if d.get_intermediate_features else [out])
            h = avg_pool_no_pad_count(h)
        return results
