"""SAMS generator, NHWC (counterpart of shineon_tpu/networks/sams/sams_generator.py).

Encoder (plain-SPADE resblocks + 0.5x nearest downsample over the previous
generated frames, conditioned on their encoder labelmaps) -> middle
(``num_middle`` width-preserving MultiSpade blocks on the current labelmap
dict) -> decoder (2x nearest upsample + MultiSpade blocks) -> conv to RGB
(+ weight mask with flow warping). Widths follow ngf_base ** pow. With
``int8`` the generator serves int8 at eval: quantized SPADE chains, and the
int8 conv wherever :func:`int8_conv_profitable` admits a 3x3 conv (the
resblock convs, and ``encode_conv_in``/``decode_conv_out`` when their
channel counts pass). Blocks named by ``attention_middle_indices`` /
``attention_decoder_indices`` (string indices, negative ones from the end)
take AttentiveMultiSpade instead of MultiSpade, and so does
``decode_extra`` whenever decoder indices are given.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from shineon_tpu_torch.datasets.channels import MASK_CHANNELS, RGB_CHANNELS, channels_for
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.sams.attentive_multispade import AttentiveMultiSpade
from shineon_tpu_torch.networks.sams.multispade import MultiSpade
from shineon_tpu_torch.networks.sams.spade import (
    SPADE,
    AnySpadeResBlock,
    int8_conv_profitable,
    parse_spade_config,
)


def resize_nearest_scale(x: torch.Tensor, scale: float) -> torch.Tensor:
    """torch ``nn.Upsample(mode="nearest")`` on NHWC for the two scales the
    generator uses: 0.5x keeps the even pixels, 2x repeats each pixel."""
    if scale == 0.5:
        return x[:, ::2, ::2, :]
    if scale == 2.0:
        return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    raise ValueError(f"unsupported nearest scale {scale}")


def choose_spade(attn_indices: Sequence[str], i: int, total_layers: int):
    """The SPADE class of block ``i`` of ``total_layers``: AttentiveMultiSpade
    where ``attn_indices`` names it by a positive or negative string index
    (reference sams_generator.py:311-317), else MultiSpade."""
    indices = [str(s) for s in attn_indices]
    if str(i) in indices or str(i - total_layers) in indices:
        return AttentiveMultiSpade
    return MultiSpade


class SamsGenerator(nn.Module):
    """See module docstring; arguments mirror the JAX module's fields."""

    @staticmethod
    def modify_commandline_options(parser, is_train):
        """The generator's options (sams_generator.py:61-100 of the JAX
        package), with the networks' --init_type and --init_variance."""
        from shineon_tpu_torch.networks import add_base_network_options

        parser = add_base_network_options(parser, is_train)
        parser.add_argument("--norm_G", default="spectralspadesyncbatch3x3")
        parser.add_argument(
            "--ngf_base", type=int, default=2,
            help="feature widths are ngf_base ** pow at each stage",
        )
        parser.add_argument(
            "--ngf_power_start", "--ngf_pow_outer", dest="ngf_pow_outer", type=int, default=6,
            help="number of features at the outer ends = ngf_base ** ngf_pow_outer",
        )
        parser.add_argument(
            "--ngf_power_end", "--ngf_pow_inner", dest="ngf_pow_inner", type=int, default=10,
            help="INCLUSIVE! number of features in the middle = ngf_base ** ngf_pow_inner",
        )
        parser.add_argument(
            "--ngf_pow_step", type=int, default=1,
            help="increment the power this much between layers until >= ngf_pow_inner",
        )
        parser.add_argument(
            "--num_middle", type=int, default=3,
            help="count of width-preserving SAMS blocks between encoder and decoder",
        )
        parser.add_argument(
            "--attention_middle_indices", nargs="*", default=[],
            help="which middle blocks get self-attention (negative indices ok)",
        )
        parser.add_argument(
            "--attention_decoder_indices", nargs="*", default=[],
            help="which decoder blocks get self-attention (negative indices ok)",
        )
        return parser

    def __init__(self, norm_G: str = "spectralspadesyncbatch3x3", ngf_base: int = 2,
                 ngf_pow_outer: int = 6, ngf_pow_inner: int = 10, ngf_pow_step: int = 1,
                 num_middle: int = 3, attention_middle_indices: Sequence[str] = (),
                 attention_decoder_indices: Sequence[str] = (), activation: str = "relu",
                 n_frames_total: int = 5, flow_warp: bool = False,
                 encoder_input: str = "flow",
                 inputs: Sequence[str] = ("agnostic", "cloth", "densepose", "flow"),
                 dtype: Optional[torch.dtype] = None, int8: bool = False,
                 int8_min_channels: int = 64):
        super().__init__()
        self.n_frames_total, self.dtype = n_frames_total, dtype
        self.num_prev = max(n_frames_total - 1, 1)
        self.enc_ch = channels_for(encoder_input)
        out_channels = RGB_CHANNELS + MASK_CHANNELS if flow_warp else RGB_CHANNELS
        enc_label_nc = self.enc_ch * (self.num_prev if n_frames_total > 1 else 1)
        labels = {name: channels_for(name) for name in inputs}
        spade_config = norm_G.replace("spectral", "")
        parse_spade_config(spade_config)
        ngf_outer = int(ngf_base ** ngf_pow_outer)
        ngf_inner = int(ngf_base ** ngf_pow_inner)

        def enc_spade(c):
            return SPADE(c, enc_label_nc, config_text=spade_config,
                         activation=activation, dtype=dtype, int8=int8)

        def cur_spade(cls):
            return lambda c: cls(c, labels, config_text=spade_config,
                                 activation=activation, dtype=dtype, int8=int8)

        block = partial(AnySpadeResBlock, norm_G=norm_G, activation=activation, dtype=dtype,
                        int8=int8, int8_min_channels=int8_min_channels)

        def conv3x3(cin, cout):
            q = int8 and int8_conv_profitable(3, cin, cout, int8_min_channels)
            return Conv2d(cin, cout, 3, padding=1, dtype=dtype, int8=q)

        self.encode_conv_in = conv3x3(RGB_CHANNELS * self.num_prev, ngf_outer)
        self.encoder = []
        out_feat = ngf_outer
        for i, pow_ in enumerate(range(ngf_pow_outer, ngf_pow_inner, ngf_pow_step)):
            in_feat = int(ngf_base ** pow_)
            out_feat = int(ngf_base ** (pow_ + ngf_pow_step))
            self.encoder.append(f"encode_{i}")
            self.add_module(f"encode_{i}", block(in_feat, out_feat, make_spade=enc_spade))
        if out_feat != ngf_inner:
            self.encoder.append("encode_extra")
            self.encode_extra = block(out_feat, ngf_inner, make_spade=enc_spade)

        self.middle = []
        for i in range(num_middle):
            cls = choose_spade(attention_middle_indices, i, num_middle)
            self.middle.append(f"middle_{i}")
            self.add_module(f"middle_{i}", block(ngf_inner, ngf_inner, make_spade=cur_spade(cls)))

        self.decoder = []
        out_feat = ngf_inner
        dec_pows = list(range(ngf_pow_inner, ngf_pow_outer, -ngf_pow_step))
        for i, pow_ in enumerate(dec_pows):
            in_feat = int(ngf_base ** pow_)
            out_feat = int(ngf_base ** (pow_ - ngf_pow_step))
            cls = choose_spade(attention_decoder_indices, i, len(dec_pows))
            self.decoder.append(f"decode_{i}")
            self.add_module(f"decode_{i}", block(in_feat, out_feat, make_spade=cur_spade(cls)))
        if out_feat != ngf_outer:
            cls = AttentiveMultiSpade if attention_decoder_indices else MultiSpade
            self.decoder.append("decode_extra")
            self.decode_extra = block(out_feat, ngf_outer, make_spade=cur_spade(cls))
        self.decode_conv_out = conv3x3(ngf_outer, out_channels)

    def forward(self, prev_n_frames: Optional[torch.Tensor],
                prev_n_labelmaps: Optional[torch.Tensor],
                current_labelmap_dict: Dict[str, torch.Tensor],
                train: bool = True, update_stats: bool = False) -> torch.Tensor:
        """prev_n_frames (B, N-1, H, W, 3) and prev_n_labelmaps
        (B, N-1, H, W, enc_ch), or None for one-frame clips; the current
        frame's labelmaps {name: (B, H, W, C)}. Returns (B, H, W, out_ch):
        f32 in training, the compute dtype at eval."""
        reference = next(iter(current_labelmap_dict.values()))
        B, H, W = reference.shape[0], reference.shape[-3], reference.shape[-2]
        num_prev = self.num_prev
        if self.n_frames_total > 1:
            x = prev_n_frames.reshape(B, num_prev, H, W, RGB_CHANNELS)
            x = x.movedim(1, -2).reshape(B, H, W, RGB_CHANNELS * num_prev)
            maps = prev_n_labelmaps.reshape(B, num_prev, H, W, self.enc_ch)
            enc_maps = maps.movedim(1, -2).reshape(B, H, W, self.enc_ch * num_prev)
        else:
            x = reference.new_zeros((B, H, W, RGB_CHANNELS * num_prev))
            enc_maps = reference.new_zeros((B, H, W, self.enc_ch))
        kw = dict(train=train, update_stats=update_stats)

        x = self.encode_conv_in(x, quantize=not train)
        for name in self.encoder:
            x = getattr(self, name)(x, enc_maps, **kw)
            x = resize_nearest_scale(x, 0.5)
        current = dict(current_labelmap_dict)
        for name in self.middle:
            x = getattr(self, name)(x, current, **kw)
        for name in self.decoder:
            x = resize_nearest_scale(x, 2.0)
            x = getattr(self, name)(x, current, **kw)
        x = self.decode_conv_out(x, quantize=not train)
        return x.float() if train else x
