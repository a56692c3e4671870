"""FlowNet2 optical-flow estimator, inference (counterpart of
shineon_tpu/networks/flownet/flownet2.py): the CSS stack (FlowNetC, then two
FlowNetS), the small-displacement branch FlowNetSD and the fusion net, with
LeakyReLU 0.1, div_flow 20 and rgb_max 255.

Submodules and layers carry the names of the published flownet2-pytorch
graph, so the ``state_dict`` of ``FlowNet2_checkpoint.pth.tar`` loads with
``strict=True`` and no renaming: ``flownetc``, ``flownets_1``,
``flownets_2``, ``flownets_d``, ``flownetfusion``; convs and deconvs as
``Sequential(conv, LeakyReLU)`` (``flownetc.conv1.0.weight``), the
``inter_conv*`` as ``Sequential(conv)``; the decoders' layers at the top
level of each sub-network; ``upsampled_flow*`` as bias-free
``ConvTranspose2d(2, 2, 4, 2, 1)``.

Every module takes and returns NHWC tensors, as the JAX module and the rest
of this package do. Inside, activations are NCHW tensors in channels_last
memory: the permutes at the boundaries are views, and cuDNN runs its NHWC
tensor-core convolutions on them without transposes.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from shineon_tpu_torch.networks.init import lecun_normal_
from shineon_tpu_torch.ops.correlation import cost_volume
from shineon_tpu_torch.ops.grid_sample import resample2d
from shineon_tpu_torch.ops.image_ops import channel_norm, resize_bilinear

__all__ = ["FlowNet2", "FlowNetC", "FlowNetS", "FlowNetSD", "FlowNetFusion"]


def _conv(cin: int, cout: int, k: int = 3, s: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, k, s, (k - 1) // 2), nn.LeakyReLU(0.1))


def _deconv(cin: int, cout: int) -> nn.Sequential:
    # ConvTranspose2d(k4, s2, p1) doubles the size: flax's ConvTranspose(k4,
    # s2, "SAME") with the taps flipped and the in/out axes swapped
    return nn.Sequential(nn.ConvTranspose2d(cin, cout, 4, 2, 1), nn.LeakyReLU(0.1))


def _inter_conv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1))  # no activation


def _predict_flow(cin: int) -> nn.Conv2d:
    return nn.Conv2d(cin, 2, 3, 1, 1)


def _upsample_flow() -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(2, 2, 4, 2, 1, bias=False)


def _crop_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x[:, :, :ref.shape[2], :ref.shape[3]]


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    """Channel concat of NCHW tensors into channels_last memory."""
    return torch.cat([x.permute(0, 2, 3, 1) for x in xs], dim=-1).permute(0, 3, 1, 2)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class _Refinement(nn.Module):
    """The FlowNetC/S decoder: flow predicted at 1/64 and refined up to 1/4
    of the input. Its layers live at the top level of the sub-network."""

    def _add_refinement(self) -> None:
        self.deconv5 = _deconv(1024, 512)
        self.deconv4 = _deconv(1026, 256)
        self.deconv3 = _deconv(770, 128)
        self.deconv2 = _deconv(386, 64)
        self.predict_flow6 = _predict_flow(1024)
        self.predict_flow5 = _predict_flow(1026)
        self.predict_flow4 = _predict_flow(770)
        self.predict_flow3 = _predict_flow(386)
        self.predict_flow2 = _predict_flow(194)
        self.upsampled_flow6_to_5 = _upsample_flow()
        self.upsampled_flow5_to_4 = _upsample_flow()
        self.upsampled_flow4_to_3 = _upsample_flow()
        self.upsampled_flow3_to_2 = _upsample_flow()

    def _refine(self, c2, c3, c4, c5, c6) -> torch.Tensor:
        up6 = self.upsampled_flow6_to_5(self.predict_flow6(c6))
        cat5 = _cat(c5, _crop_like(self.deconv5(c6), c5), _crop_like(up6, c5))
        up5 = self.upsampled_flow5_to_4(self.predict_flow5(cat5))
        cat4 = _cat(c4, _crop_like(self.deconv4(cat5), c4), _crop_like(up5, c4))
        up4 = self.upsampled_flow4_to_3(self.predict_flow4(cat4))
        cat3 = _cat(c3, _crop_like(self.deconv3(cat4), c3), _crop_like(up4, c3))
        up3 = self.upsampled_flow3_to_2(self.predict_flow3(cat3))
        cat2 = _cat(c2, _crop_like(self.deconv2(cat3), c2), _crop_like(up3, c2))
        return self.predict_flow2(cat2)


class FlowNetC(_Refinement):
    """Siamese towers + cost volume (max displacement 20, stride 2: 441
    channels). (B, H, W, 3) x2 -> flow (B, H/4, W/4, 2)."""

    def __init__(self, max_displacement: int = 20, corr_stride: int = 2):
        super().__init__()
        self.max_displacement, self.corr_stride = max_displacement, corr_stride
        self.conv1 = _conv(3, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.conv3 = _conv(128, 256, 5, 2)
        self.conv_redir = _conv(256, 32, 1, 1)
        self.conv3_1 = _conv(473, 256)
        self.conv4 = _conv(256, 512, 3, 2)
        self.conv4_1 = _conv(512, 512)
        self.conv5 = _conv(512, 512, 3, 2)
        self.conv5_1 = _conv(512, 512)
        self.conv6 = _conv(512, 1024, 3, 2)
        self.conv6_1 = _conv(1024, 1024)
        self._add_refinement()

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        B = x1.shape[0]
        # the two towers share their weights: one pass over both frames
        b = self.conv2(self.conv1(_nchw(torch.cat([x1, x2]))))
        c = self.conv3(b)
        b1, c1, c2 = b[:B], c[:B], c[B:]
        corr = F.leaky_relu(_nchw(cost_volume(_nhwc(c1), _nhwc(c2), self.max_displacement,
                                              self.corr_stride)), 0.1)
        c3_1 = self.conv3_1(_cat(self.conv_redir(c1), corr))
        c4_1 = self.conv4_1(self.conv4(c3_1))
        c5_1 = self.conv5_1(self.conv5(c4_1))
        c6_1 = self.conv6_1(self.conv6(c5_1))
        return _nhwc(self._refine(b1, c3_1, c4_1, c5_1, c6_1))


class FlowNetS(_Refinement):
    """Plain encoder on the channel-stacked input (12 channels in the CSS
    stack). (B, H, W, 12) -> flow (B, H/4, W/4, 2)."""

    def __init__(self, in_channels: int = 12):
        super().__init__()
        self.conv1 = _conv(in_channels, 64, 7, 2)
        self.conv2 = _conv(64, 128, 5, 2)
        self.conv3 = _conv(128, 256, 5, 2)
        self.conv3_1 = _conv(256, 256)
        self.conv4 = _conv(256, 512, 3, 2)
        self.conv4_1 = _conv(512, 512)
        self.conv5 = _conv(512, 512, 3, 2)
        self.conv5_1 = _conv(512, 512)
        self.conv6 = _conv(512, 1024, 3, 2)
        self.conv6_1 = _conv(1024, 1024)
        self._add_refinement()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c2 = self.conv2(self.conv1(_nchw(x)))
        c3_1 = self.conv3_1(self.conv3(c2))
        c4_1 = self.conv4_1(self.conv4(c3_1))
        c5_1 = self.conv5_1(self.conv5(c4_1))
        c6_1 = self.conv6_1(self.conv6(c5_1))
        return _nhwc(self._refine(c2, c3_1, c4_1, c5_1, c6_1))


class FlowNetSD(nn.Module):
    """Small-displacement branch: a stride-1 conv0 and a decoder with
    inter-convs. (B, H, W, 6) -> flow (B, H/4, W/4, 2)."""

    def __init__(self):
        super().__init__()
        self.conv0 = _conv(6, 64)
        self.conv1 = _conv(64, 64, 3, 2)
        self.conv1_1 = _conv(64, 128)
        self.conv2 = _conv(128, 128, 3, 2)
        self.conv2_1 = _conv(128, 128)
        self.conv3 = _conv(128, 256, 3, 2)
        self.conv3_1 = _conv(256, 256)
        self.conv4 = _conv(256, 512, 3, 2)
        self.conv4_1 = _conv(512, 512)
        self.conv5 = _conv(512, 512, 3, 2)
        self.conv5_1 = _conv(512, 512)
        self.conv6 = _conv(512, 1024, 3, 2)
        self.conv6_1 = _conv(1024, 1024)
        self.deconv5 = _deconv(1024, 512)
        self.deconv4 = _deconv(1026, 256)
        self.deconv3 = _deconv(770, 128)
        self.deconv2 = _deconv(386, 64)
        self.inter_conv5 = _inter_conv(1026, 512)
        self.inter_conv4 = _inter_conv(770, 256)
        self.inter_conv3 = _inter_conv(386, 128)
        self.inter_conv2 = _inter_conv(194, 64)
        self.predict_flow6 = _predict_flow(1024)
        self.predict_flow5 = _predict_flow(512)
        self.predict_flow4 = _predict_flow(256)
        self.predict_flow3 = _predict_flow(128)
        self.predict_flow2 = _predict_flow(64)
        self.upsampled_flow6_to_5 = _upsample_flow()
        self.upsampled_flow5_to_4 = _upsample_flow()
        self.upsampled_flow4_to_3 = _upsample_flow()
        self.upsampled_flow3_to_2 = _upsample_flow()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_1 = self.conv1_1(self.conv1(self.conv0(_nchw(x))))
        c2_1 = self.conv2_1(self.conv2(c1_1))
        c3_1 = self.conv3_1(self.conv3(c2_1))
        c4_1 = self.conv4_1(self.conv4(c3_1))
        c5_1 = self.conv5_1(self.conv5(c4_1))
        c6_1 = self.conv6_1(self.conv6(c5_1))

        up6 = self.upsampled_flow6_to_5(self.predict_flow6(c6_1))
        cat5 = _cat(c5_1, _crop_like(self.deconv5(c6_1), c5_1), _crop_like(up6, c5_1))
        up5 = self.upsampled_flow5_to_4(self.predict_flow5(self.inter_conv5(cat5)))
        cat4 = _cat(c4_1, _crop_like(self.deconv4(cat5), c4_1), _crop_like(up5, c4_1))
        up4 = self.upsampled_flow4_to_3(self.predict_flow4(self.inter_conv4(cat4)))
        cat3 = _cat(c3_1, _crop_like(self.deconv3(cat4), c3_1), _crop_like(up4, c3_1))
        up3 = self.upsampled_flow3_to_2(self.predict_flow3(self.inter_conv3(cat3)))
        cat2 = _cat(c2_1, _crop_like(self.deconv2(cat3), c2_1), _crop_like(up3, c2_1))
        return _nhwc(self.predict_flow2(self.inter_conv2(cat2)))


class FlowNetFusion(nn.Module):
    """Fuses the CSS and SD flows at full resolution. (B, H, W, 11) -> flow
    (B, H, W, 2)."""

    def __init__(self):
        super().__init__()
        self.conv0 = _conv(11, 64)
        self.conv1 = _conv(64, 64, 3, 2)
        self.conv1_1 = _conv(64, 128)
        self.conv2 = _conv(128, 128, 3, 2)
        self.conv2_1 = _conv(128, 128)
        self.deconv1 = _deconv(128, 32)
        self.deconv0 = _deconv(162, 16)
        self.inter_conv1 = _inter_conv(162, 32)
        self.inter_conv0 = _inter_conv(82, 16)
        self.predict_flow2 = _predict_flow(128)
        self.predict_flow1 = _predict_flow(32)
        self.predict_flow0 = _predict_flow(16)
        self.upsampled_flow2_to_1 = _upsample_flow()
        self.upsampled_flow1_to_0 = _upsample_flow()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0 = self.conv0(_nchw(x))
        c1_1 = self.conv1_1(self.conv1(c0))
        c2_1 = self.conv2_1(self.conv2(c1_1))

        up2 = self.upsampled_flow2_to_1(self.predict_flow2(c2_1))
        cat1 = _cat(c1_1, _crop_like(self.deconv1(c2_1), c1_1), _crop_like(up2, c1_1))
        up1 = self.upsampled_flow1_to_0(self.predict_flow1(self.inter_conv1(cat1)))
        cat0 = _cat(c0, _crop_like(self.deconv0(cat1), c0), _crop_like(up1, c0))
        return _nhwc(self.predict_flow0(self.inter_conv0(cat0)))


def _up4(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, (4 * x.shape[1], 4 * x.shape[2]))


class FlowNet2(nn.Module):
    """Stacked C -> S -> S with the SD branch and fusion (inference graph).

    Input: two RGB images (B, H, W, 3) on [0, 255], H and W multiples of
    64. Output: (B, H, W, 2) flow in pixels, (dx, dy).
    """

    def __init__(self, div_flow: float = 20.0, rgb_max: float = 255.0):
        super().__init__()
        self.div_flow, self.rgb_max = div_flow, rgb_max
        self.flownetc = FlowNetC()
        self.flownets_1 = FlowNetS()
        self.flownets_2 = FlowNetS()
        self.flownets_d = FlowNetSD()
        self.flownetfusion = FlowNetFusion()

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's random init: flax's lecun normal on every conv
        and deconv kernel (fan_in = kh * kw * input channels), zero biases."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                # a deconv's weight is (in, out, kh, kw): its transpose is
                # read as OIHW
                w = m.weight.transpose(0, 1) if m.transposed else m.weight
                lecun_normal_(w, generator)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
        im1, im2 = im1.float(), im2.float()
        # the per-pair mean of each colour over both frames
        rgb_mean = torch.stack([im1, im2], dim=1).mean(dim=(1, 2, 3))[:, None, None]
        x1 = (im1 - rgb_mean) / self.rgb_max
        x2 = (im2 - rgb_mean) / self.rgb_max
        div = self.div_flow

        flowc = _up4(self.flownetc(x1, x2) * div)
        warped1 = resample2d(x2, flowc)
        s1_in = torch.cat([x1, x2, warped1, flowc / div, channel_norm(x1 - warped1)], dim=-1)
        flows1 = _up4(self.flownets_1(s1_in) * div)

        warped2 = resample2d(x2, flows1)
        s2_in = torch.cat([x1, x2, warped2, flows1 / div, channel_norm(x1 - warped2)], dim=-1)
        flow_css = _up4(self.flownets_2(s2_in) * div)

        # flownet2-pytorch divides the upsampled SD flow by div_flow
        flow_sd = _up4(self.flownets_d(torch.cat([x1, x2], dim=-1))) / div

        diff_sd = channel_norm(x1 - resample2d(x2, flow_sd))
        diff_css = channel_norm(x1 - resample2d(x2, flow_css))
        fuse_in = torch.cat([x1, flow_sd, flow_css, channel_norm(flow_sd),
                             channel_norm(flow_css), diff_sd, diff_css], dim=-1)
        return self.flownetfusion(fuse_in)
