"""SPADE normalization + AnySpadeResBlock, NHWC (counterpart of
shineon_tpu/networks/sams/spade.py).

At eval every 3x3 SPADE site runs through the fused chain kernel
(:func:`shineon_tpu_torch.ops.fused_spade.fused_multispade_modulate`); in
training the reference formulation runs conv by conv. Modules built with
``int8=True`` serve int8 at eval (the JAX package's ``SHINEON_INT8_SPADE``
mode): every fused chain is quantized, and every resblock conv that
:func:`int8_conv_profitable` admits runs the int8 conv.
"""

from __future__ import annotations

import re
from typing import Optional

import torch
from torch import nn

from shineon_tpu_torch import tracing
from shineon_tpu_torch.networks.activation import (
    get_activation_fn,
    get_resblock_activation_fn,
)
from shineon_tpu_torch.networks.layers import Conv2d, EvalCache
from shineon_tpu_torch.networks.normalization import (
    SpectralConv2d,
    SyncBatchNorm,
    instance_norm,
)
from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate, pack_weights


def int8_conv_profitable(ks: int, cin: int, cout: int, min_channels: int = 64) -> bool:
    """The JAX package's int8 serving gate: a kernel of at least 3x3 and both
    channel counts >= ``min_channels`` (its ``SHINEON_INT8_MIN_CH``, default
    64; its spatial gate is off by default and not kept)."""
    return ks >= 3 and min(cin, cout) >= min_channels


def parse_spade_config(config_text: str) -> tuple[str, int]:
    """'spadesyncbatch3x3' -> ('syncbatch', 3)."""
    if not config_text.startswith("spade"):
        raise ValueError(f"not a SPADE config: {config_text!r}")
    parsed = re.search(r"spade(\D+)(\d)x\d", config_text)
    norm_type = str(parsed.group(1))
    if norm_type not in ("instance", "syncbatch", "batch"):
        raise ValueError(f"SPADE config names an unknown param-free norm: {norm_type}")
    return norm_type, int(parsed.group(2))


def resize_nearest(segmap: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """torch ``F.interpolate(mode="nearest")`` on NHWC: src = floor(dst * in/out)."""
    in_h, in_w = segmap.shape[-3], segmap.shape[-2]
    if (in_h, in_w) == (h, w):
        return segmap
    if in_h % h == 0 and in_w % w == 0:
        # integer factors: floor(dst * k) = dst * k, a strided view
        return segmap[..., :: in_h // h, :: in_w // w, :]
    dev = segmap.device
    rows = torch.floor(torch.arange(h, dtype=torch.float32, device=dev) * (in_h / h)).long()
    cols = torch.floor(torch.arange(w, dtype=torch.float32, device=dev) * (in_w / w)).long()
    return segmap.index_select(-3, rows).index_select(-2, cols)


class SPADE(nn.Module):
    """Param-free norm + segmap-conditioned (1 + gamma, beta) modulation.

    ``forward`` is the reference formulation, conv by conv (``hidden`` skips
    the mlp_shared conv when a parent computed it). ``fused_args`` returns
    the chain arguments ``(ab, seg, wsh, bsh, wgb, bgb)`` of this label for
    the kernel; ``forward_fused`` runs the kernel on this label alone (see
    :func:`fused_chain`), quantized when built with ``int8``.
    """

    def __init__(self, norm_nc: int, label_nc: int, config_text: str = "spadeinstance3x3",
                 activation: str = "relu", nhidden: int = 128,
                 dtype: Optional[torch.dtype] = None, int8: bool = False):
        super().__init__()
        self.norm_type, ks = parse_spade_config(config_text)
        self.ks, self.activation, self.dtype, self.int8 = ks, activation, dtype, int8
        if self.norm_type != "instance":
            self.norm = SyncBatchNorm(norm_nc, affine=False, dtype=dtype)
        pad = ks // 2
        self.mlp_shared = Conv2d(label_nc, nhidden, ks, padding=pad, dtype=dtype)
        self.mlp_gamma = Conv2d(nhidden, norm_nc, ks, padding=pad, dtype=dtype)
        self.mlp_beta = Conv2d(nhidden, norm_nc, ks, padding=pad, dtype=dtype)
        self._packed = EvalCache()

    def _normalize(self, x, train, return_affine=False):
        if self.norm_type == "instance":
            return instance_norm(x, return_affine=return_affine, dtype=self.dtype)
        return self.norm(x, use_running_average=not train, return_affine=return_affine)

    def forward(self, x, segmap, train: bool = True, hidden: Optional[torch.Tensor] = None):
        segmap = resize_nearest(segmap, x.shape[-3], x.shape[-2]).to(x.dtype)
        normalized = self._normalize(x, train)
        h = hidden
        if h is None:
            h = get_activation_fn(self.activation)(self.mlp_shared(segmap))
        gamma = self.mlp_gamma(h)
        beta = self.mlp_beta(h)
        return normalized * (1.0 + gamma) + beta

    def gb_params(self):
        """[gamma | beta] conv weight (2C, nhidden, k, k) and bias (2C,)."""
        w = torch.cat([self.mlp_gamma.weight, self.mlp_beta.weight], dim=0)
        b = torch.cat([self.mlp_gamma.bias, self.mlp_beta.bias], dim=0)
        return w, b

    def fused_args(self, x, segmap):
        """Eval: the norm folded with running (or instance) statistics."""
        B, C = x.shape[0], x.shape[-1]
        a, b = self._normalize(x, train=False, return_affine=True)
        ab = torch.cat([a.expand(B, C), b.expand(B, C)], dim=-1).float()
        seg = resize_nearest(segmap, x.shape[-3], x.shape[-2]).to(x.dtype)
        wgb, bgb = self.gb_params()
        return ab, seg, self.mlp_shared.weight, self.mlp_shared.bias, wgb, bgb

    def forward_fused(self, x, segmap):
        """Eval: this label alone, as a one-label chain."""
        return fused_chain([self], x, [segmap])


def fused_chain(spades, x, segmaps):
    """Eval: the SPADEs applied to x in turn as ONE kernel call, each norm
    folded with its running statistics (instance statistics only in a chain
    of one: they depend on the chain's running value), quantized if the
    SPADEs were built with ``int8``. Outside autograd the chain's weights
    are packed once into the kernel's layout and kept on its first SPADE
    until a weight changes (on the card: on the CPU the chain takes its
    plain version, which reads the OIHW weights). A span, ``spade.chain``."""
    with tracing.span("spade.chain"):
        per_label = [s.fused_args(x, m) for s, m in zip(spades, segmaps)]
        abs_, segs, wshs, bshs, wgbs, bgbs = zip(*per_label)
        quantized = spades[0].int8
        packed = None
        if x.is_cuda and not torch.is_grad_enabled():
            packed = spades[0]._packed.get(
                [p for s in spades for p in s.parameters()], (x.dtype, quantized),
                lambda: pack_weights(wshs, bshs, wgbs, bgbs, x.dtype, quantized),
            )
        return fused_multispade_modulate(
            x, torch.stack(abs_, dim=1), segs, wshs, bshs, wgbs, bgbs,
            act_name=spades[0].activation, packed=packed, quantized=quantized,
        )


class AnySpadeResBlock(nn.Module):
    """SPADE ResNet block (reference spade.py:106-192). ``make_spade(channels)``
    builds each normalization sub-module (SPADE or MultiSpade);
    spectral norm wraps the convs when "spectral" is in ``norm_G``. At eval a
    plain SPADE runs fused; a MultiSpade fuses its own chain. With ``int8``
    the convs that :func:`int8_conv_profitable` admits run int8 at eval."""

    def __init__(self, fin: int, fout: int, norm_G: str, make_spade,
                 activation: str = "relu", dtype: Optional[torch.dtype] = None,
                 int8: bool = False, int8_min_channels: int = 64):
        super().__init__()
        self.learned_shortcut = fin != fout
        fmiddle = min(fin, fout)
        spectral = "spectral" in norm_G
        self.actvn = get_resblock_activation_fn(activation)

        def conv(cin, cout, ksize, bias):
            cls = SpectralConv2d if spectral else Conv2d
            q = int8 and int8_conv_profitable(ksize, cin, cout, int8_min_channels)
            return cls(cin, cout, ksize, padding=ksize // 2, bias=bias, dtype=dtype, int8=q)

        if self.learned_shortcut:
            self.norm_s = make_spade(fin)
            self.conv_s = conv(fin, fout, 1, False)
        self.spade_0 = make_spade(fin)
        self.conv_0 = conv(fin, fmiddle, 3, True)
        self.spade_1 = make_spade(fmiddle)
        self.conv_1 = conv(fmiddle, fout, 3, True)

    @staticmethod
    def _conv(layer, h, train, update_stats):
        if isinstance(layer, SpectralConv2d):
            return layer(h, update_stats=update_stats, quantize=not train)
        return layer(h, quantize=not train)

    @staticmethod
    def _spade(module, h, seg, train):
        if not train and isinstance(module, SPADE) and module.ks == 3:
            return module.forward_fused(h, seg)
        return module(h, seg, train=train)

    def forward(self, x, seg, train: bool = True, update_stats: bool = False):
        with tracing.span("sams.resblock"):
            if self.learned_shortcut:
                x_s = self._conv(self.conv_s, self._spade(self.norm_s, x, seg, train), train,
                                 update_stats)
            else:
                x_s = x
            dx = self._spade(self.spade_0, x, seg, train)
            dx = self._conv(self.conv_0, self.actvn(dx), train, update_stats)
            dx = self._spade(self.spade_1, dx, seg, train)
            dx = self._conv(self.conv_1, self.actvn(dx), train, update_stats)
            return x_s + dx

