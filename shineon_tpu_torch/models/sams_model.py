"""SAMS serving model: features and autoregressive clip generation
(counterpart of the eval and warm-up parts of shineon_tpu/models/sams_model.py).

Compute-dtype policy (shineon_tpu/models/base_model.py:88-94): ``precision
16`` runs the networks in bf16 while parameters stay f32; flows, sampling
grids and norm statistics stay f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from shineon_tpu_torch.datasets.channels import RGB_CHANNELS, channels_for
from shineon_tpu_torch.datasets.preprocess import PreprocessConfig, preprocess_batch
from shineon_tpu_torch.networks.attention import INIT_STD as attention_init_std
from shineon_tpu_torch.networks.attention import SelfAttention
from shineon_tpu_torch.networks.init import lecun_normal_, normal_
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.normalization import SpectralConv2d
from shineon_tpu_torch.networks.sams.sams_generator import SamsGenerator
from shineon_tpu_torch.ops import resample2d


def compute_dtype_of(opt) -> Optional[torch.dtype]:
    return torch.bfloat16 if getattr(opt, "precision", 32) == 16 else None


class SamsModel:
    """Owns the generator; ``generate_n_frames`` is the clip loop."""

    def __init__(self, opt, device="cuda"):
        self.opt = opt
        self.n_frames_total = opt.n_frames_total
        self.n_frames_now = getattr(opt, "n_frames_now", None) or self.n_frames_total
        self.inputs = list(opt.person_inputs) + list(opt.cloth_inputs)
        self.compute_dtype = compute_dtype_of(opt)
        self.preprocess_config = PreprocessConfig.from_opt(opt)
        self.generator = SamsGenerator(
            norm_G=opt.norm_G, ngf_base=opt.ngf_base, ngf_pow_outer=opt.ngf_pow_outer,
            ngf_pow_inner=opt.ngf_pow_inner, ngf_pow_step=opt.ngf_pow_step,
            num_middle=opt.num_middle,
            attention_middle_indices=tuple(opt.attention_middle_indices),
            attention_decoder_indices=tuple(opt.attention_decoder_indices),
            activation=opt.activation or "relu", n_frames_total=self.n_frames_total,
            flow_warp=opt.flow_warp, encoder_input=opt.encoder_input,
            inputs=tuple(self.inputs), dtype=self.compute_dtype,
            int8=opt.int8_spade, int8_min_channels=opt.int8_min_channels,
        ).to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX package's rules: flax's defaults (lecun-normal kernels,
        zero biases, spectral ``u`` ~ N(0, 1)), except the attention blocks'
        1x1 convs, N(0, 0.02), and their gamma, 0. Drawn on the CPU, then
        copied to the device."""
        attention_convs = set()
        for m in self.generator.modules():  # a block comes before its convs
            if isinstance(m, SelfAttention):
                attention_convs.update(m.convs())
                m.gamma.zero_()
            if isinstance(m, (Conv2d, SpectralConv2d)):
                w = torch.empty(m.weight.shape)
                if m in attention_convs:
                    normal_(w, attention_init_std, generator)
                else:
                    lecun_normal_(w, generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            if isinstance(m, SpectralConv2d):
                m.u.copy_(torch.randn(m.u.shape, generator=generator))
                m.sigma.fill_(1.0)

    def features(self, raw_batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """SAMS keeps the frames axis: (B, N, H, W, C) features."""
        return preprocess_batch(raw_batch, self.preprocess_config)

    def generate_n_frames(self, feats: Dict[str, torch.Tensor], train: bool):
        """Autoregressive clip synthesis (sams_model.py:244-396 of the JAX
        package; its ``lax.scan`` is a Python loop here).

        In training mode (the serving warm-up) the generator runs with batch
        statistics and updates its running statistics and spectral ``u`` in
        place. Returns (fake_frame, current_maps, all_frames (B, N, H, W, 3)).
        """
        opt = self.opt
        N = self.n_frames_total
        start_idx = N - self.n_frames_now
        labelmap = {key: feats[key] for key in self.inputs}
        enc_maps = feats[opt.encoder_input]  # (B, N, H, W, enc_ch)
        image = feats["image"]
        flows = feats.get("flow") if opt.flow_warp else None  # stays f32
        if not train and self.compute_dtype is not None:
            labelmap = {k: v.to(self.compute_dtype) for k, v in labelmap.items()}
            enc_maps = enc_maps.to(self.compute_dtype)
        g = self.generator

        if N == 1:
            current_maps = {k: v[:, 0] for k, v in labelmap.items()}
            out = g(None, None, current_maps, train=train, update_stats=train)
            fake = out[..., :RGB_CHANNELS]
            if opt.flow_warp:
                wmask = out[..., RGB_CHANNELS:]
                warped = resample2d(torch.zeros_like(fake), flows[:, 0])
                fake = (1 - wmask) * warped + wmask * fake
            return fake, current_maps, fake[:, None]

        win_dtype = image.dtype if train else (self.compute_dtype or image.dtype)
        # the previous-frame window [oldest .. newest], zeros until generated
        window = torch.zeros(image.shape[:1] + (N - 1,) + image.shape[2:],
                             dtype=win_dtype, device=image.device)
        fakes = []
        for t in range(start_idx, N):
            k = (N - 1) - t
            prev_maps = torch.cat(
                [torch.zeros_like(enc_maps[:, :k]), enc_maps[:, k:N - 1]], dim=1
            )
            current_maps = {key: v[:, t] for key, v in labelmap.items()}
            out = g(window, prev_maps, current_maps, train=train, update_stats=train)
            fake = out[..., :RGB_CHANNELS]
            if opt.flow_warp:
                wmask = out[..., RGB_CHANNELS:]
                # the reference warps buffer[t-1], the window's newest slot
                warped = resample2d(window[:, -1], flows[:, t])
                fake = (1 - wmask) * warped + wmask * fake
            window = torch.cat([window[:, 1:], fake[:, None].to(window.dtype)], dim=1)
            fakes.append(fake)
        gen_frames = torch.stack(fakes, dim=1)
        if start_idx:
            gen_frames = torch.cat(
                [gen_frames.new_zeros(gen_frames[:, :1].shape).repeat(1, start_idx, 1, 1, 1),
                 gen_frames], dim=1,
            )
        current_maps = {k: v[:, N - 1] for k, v in labelmap.items()}
        return fakes[-1], current_maps, gen_frames


def channels_of(names) -> int:
    return sum(channels_for(n) for n in names)
