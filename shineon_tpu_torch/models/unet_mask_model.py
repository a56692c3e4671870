"""TOM, the U-Net try-on model with mask compositing and an optional flow
warp (counterpart of shineon_tpu/models/unet_mask_model.py): its forward,
losses, and training, validation, visual and test steps.

The U-Net sees every frame's person and cloth features stacked on the
channel axis and returns, per frame, a render (tanh), a try-on mask
(sigmoid) and, with ``flow_warp``, a flow mask (sigmoid). Frame f's
composite blends its render with the previous composite warped by the
frame's flow (``resample2d``, the gradient live through it, as in the JAX
package), then with the warped cloth by the try-on mask. On the card the
U-Net's attention blocks run the SAGAN attention kernel.
"""

from __future__ import annotations

import argparse
import math
import os.path as osp
from typing import Dict

import torch

from shineon_tpu_torch.datasets.channels import RGB_CHANNELS
from shineon_tpu_torch.models.base_model import (
    BaseModel,
    get_and_cat_inputs,
    gradients,
    to_numpy,
)
from shineon_tpu_torch.networks.attention import SelfAttention
from shineon_tpu_torch.networks.cpvton.unet import UnetGenerator
from shineon_tpu_torch.networks.init import normal_
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.loss import VGGLoss, l1_loss
from shineon_tpu_torch.networks.vgg import load_vgg19
from shineon_tpu_torch.ops import resample2d
from shineon_tpu_torch.training.state import TrainState
from shineon_tpu_torch.utils.visualization import get_save_paths, save_images

INIT_STD = 0.02  # every U-Net conv, the attention blocks' too: N(0, 0.02)


def tom_ngf(n_frames: int) -> int:
    """The U-Net's width grows with the frame count, not with --ngf:
    int(64 (ln n + 1)) (unet_mask_model.py:55 of the reference), 64 at one
    frame and 167 at five."""
    return int(64 * (math.log(n_frames) + 1))


class UnetMaskModel(BaseModel):
    """Owns the U-Net and, for training, the VGG perceptual loss."""

    @classmethod
    def modify_commandline_options(cls, parser: argparse.ArgumentParser, is_train):
        parser = argparse.ArgumentParser(parents=[parser], add_help=False)
        parser = super().modify_commandline_options(parser, is_train)
        parser.set_defaults(person_inputs=("agnostic", "densepose"))
        parser.add_argument(
            "--pen_flow_mask", type=float, default=1.0,
            help="weight of the flow-mask penalty term",
        )
        return parser

    def __init__(self, opt, device="cuda"):
        super().__init__(opt, device)
        n = self.n_frames_total
        self.unet = UnetGenerator(
            input_nc=(self.person_channels + self.cloth_channels) * n,
            output_nc=5 * n if opt.flow_warp else 4 * n,
            num_downs=6, num_attention=opt.num_attn, ngf=tom_ngf(n), norm="instance",
            use_self_attn=opt.self_attn, activation=opt.activation, dtype=self.compute_dtype,
        ).to(self.device)
        # the VGG term always counts in TOM's loss: random filters only when
        # asked for (or when not training)
        vgg = load_vgg19(allow_random=opt.allow_random_vgg or not opt.is_train,
                         dtype=self.compute_dtype)
        self.criterion_vgg = VGGLoss(vgg.to(self.device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX package's rules: every conv kernel N(0, 0.02), biases
        zero, attention gammas zero. Drawn on the CPU, then copied."""
        for m in self.unet.modules():
            if isinstance(m, SelfAttention):
                m.gamma.zero_()
            if isinstance(m, Conv2d):
                m.weight.copy_(normal_(torch.empty(m.weight.shape), INIT_STD, generator))
                m.bias.zero_()

    def init_state(self, generator: torch.Generator, steps_per_epoch: int) -> TrainState:
        """The U-Net's weights from ``generator``, then :meth:`make_state`."""
        self.init_weights(generator)
        return self.make_state(steps_per_epoch)

    def make_state(self, steps_per_epoch: int) -> TrainState:
        """Step 0 and Adam at ``lr`` over the U-Net's current weights."""
        return TrainState(nets={"unet": self.net_state(self.unet, getattr(self.opt, "lr", 1e-4),
                                                       steps_per_epoch)})

    def forward(self, feats: Dict[str, torch.Tensor]):
        """(renders, try-on masks, composites, flow masks or None), each
        with its frames stacked on the channel axis (3, 1, 3, 1 a frame)."""
        n = self.n_frames_total
        person = get_and_cat_inputs(feats, self.opt.person_inputs)
        cloth = get_and_cat_inputs(feats, self.opt.cloth_inputs)
        outputs = self.unet(torch.cat([person, cloth], dim=-1))
        p_rendereds = torch.tanh(outputs[..., :3 * n])
        tryon_masks = torch.sigmoid(outputs[..., 3 * n:4 * n])
        flow_masks = torch.sigmoid(outputs[..., 4 * n:]) if self.opt.flow_warp else None
        flows = feats.get("flow") if self.opt.flow_warp else None
        warped_cloths = feats["cloth"]
        frames = []
        for f in range(n):
            p_rendered = p_rendereds[..., 3 * f:3 * (f + 1)]
            if flows is not None and f > 0:
                warped = resample2d(frames[f - 1], flows[..., 2 * f:2 * (f + 1)])
                fmask = flow_masks[..., f:f + 1]
                p_rendered = (1 - fmask) * warped + fmask * p_rendered
            tmask = tryon_masks[..., f:f + 1]
            frames.append((1 - tmask) * p_rendered + tmask * warped_cloths[..., 3 * f:3 * (f + 1)])
        return p_rendereds, tryon_masks, torch.cat(frames, dim=-1), flow_masks

    def losses(self, feats: Dict[str, torch.Tensor]):
        """(loss, metrics, outputs of :meth:`forward`): L1, VGG and the
        try-on mask's L1 of the last frame, each averaged with the frame
        before it when there is one, plus the flow-mask penalty: the last
        flow mask's SUM (not mean, as the reference) times pen_flow_mask."""
        n = self.n_frames_total
        outputs = self.forward(feats)
        _, tryon_masks, p_tryons, flow_masks = outputs
        im, cm = feats["image"], feats["cloth_mask"]

        def frame(x, ch, i):  # channels of frame i
            return x[..., i * ch:(i + 1) * ch]

        def terms(i):
            tryon, target = frame(p_tryons, 3, i), frame(im, 3, i)
            return (l1_loss(tryon, target), self.criterion_vgg(tryon, target),
                    l1_loss(frame(tryon_masks, 1, i), frame(cm, 1, i)))

        l1_curr, vgg_curr, mask_curr = terms(n - 1)
        if n > 1:
            l1_prev, vgg_prev, mask_prev = terms(n - 2)
            loss_l1 = 0.5 * (l1_curr + l1_prev)
            loss_vgg = 0.5 * (vgg_curr + vgg_prev)
            loss_mask = 0.5 * (mask_curr + mask_prev)
        else:
            loss_l1, loss_vgg, loss_mask = l1_curr, vgg_curr, mask_curr
        if flow_masks is not None:
            loss_flow = flow_masks[..., n - 1:n].float().sum() * self.opt.pen_flow_mask
        else:
            loss_flow = torch.zeros((), device=p_tryons.device)
        loss = loss_l1 + loss_vgg + loss_mask + loss_flow
        metrics = {
            "loss/G": loss,
            "loss/G/l1": loss_l1,
            "loss/G/vgg": loss_vgg,
            "loss/G/tryon_mask_l1": loss_mask,
            "loss/G/flow_mask_l1": loss_flow,
        }
        if n > 1:
            metrics.update({
                "loss/G/l1_prev": l1_prev, "loss/G/vgg_prev": vgg_prev,
                "loss/G/tryon_mask_prev": mask_prev, "loss/G/l1_curr": l1_curr,
                "loss/G/vgg_curr": vgg_curr, "loss/G/tryon_mask_curr": mask_curr,
            })
        return loss, metrics, outputs

    def make_train_step(self):
        """``step(state, raw_batch) -> metrics``, updating ``state`` in place."""

        def train_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            net = state.nets["unet"]
            lr = net.optimizer.schedule(state.step)
            loss, metrics, _ = self.losses(self.features(raw_batch))
            net.optimizer.step(gradients(loss, net.optimizer.params))
            state.step += 1
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["lr"] = lr
            return metrics

        return train_step

    def make_val_step(self):
        """``step(state, raw_batch) -> metrics``, without gradient;
        ``checkpoint_on`` is the loss."""

        @torch.no_grad()
        def val_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            loss, metrics, _ = self.losses(self.features(raw_batch))
            metrics["checkpoint_on"] = loss
            return metrics

        return val_step

    def make_visual_step(self):
        """``step(state, raw_batch) -> tensors``: the last frame's render,
        try-on mask and composite beside its inputs."""

        @torch.no_grad()
        def visual_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            feats = self.features(raw_batch)
            _, _, (p_rendereds, tryon_masks, p_tryons, _) = self.losses(feats)
            out = {
                "cloth": feats["cloth"][..., -3:],
                "cloth_mask": feats["cloth_mask"][..., -1:],
                "tryon_mask": tryon_masks[..., -1:],
                "p_rendered": p_rendereds[..., -3:],
                "p_tryon": p_tryons[..., -3:],
                "image": feats["image"][..., -3:],
                "prev_image": feats["prev_image"][..., -3:],
            }
            for name in ("silhouette", "im_head", "im_cocopose", "densepose"):
                if name in feats:
                    out[name] = feats[name]
            return out

        return visual_step

    def visual_rows(self, v):
        """The board grid (unet_mask_model.py:220-248 of the reference)."""
        return [
            self.fetch_person_visuals(v),
            [v["cloth"], v["cloth_mask"] * 2 - 1, v["tryon_mask"] * 2 - 1],
            [v["p_rendered"], v["p_tryon"], v["image"], v["prev_image"]],
        ]

    def test_step(self, state: TrainState, device_batch, host_batch) -> None:
        """Write the last frame's composite under ``tryon/`` or
        ``reconstruction/`` (unet_mask_model.py:266- of the JAX package),
        skipping a batch whose files all exist and each file that exists."""
        dirs, names = self.export_targets(host_batch, "image_name", self.export_task())
        if all(osp.exists(p) for p in get_save_paths(dirs, names)):
            return
        save_images(to_numpy(self.test_fn(state, device_batch)), names, dirs)

    def test_fn(self, state: TrainState, raw_batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The test forward: the last frame's composite (B, H, W, 3)."""
        with torch.no_grad():
            _, _, p_tryons, _ = self.forward(self.features(raw_batch))
        return p_tryons[..., -RGB_CHANNELS:]
