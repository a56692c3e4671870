"""GAN and perceptual losses (counterpart of shineon_tpu/networks/loss.py;
reference models/networks/loss.py:13-122): plain functions of tensors, the
arithmetic in f32."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from shineon_tpu_torch.networks.vgg import Vgg19Features


class GANLoss:
    """ls / original / w / hinge adversarial losses, with the multiscale
    list handling of loss.py:89-103."""

    AVAILABLE_MODES = ("ls", "original", "w", "hinge")

    def __init__(self, gan_mode: str = "hinge"):
        if gan_mode not in self.AVAILABLE_MODES:
            raise ValueError(f"unknown GAN mode: {gan_mode!r}")
        self.gan_mode = gan_mode

    def _loss(self, x: torch.Tensor, target_is_real: bool, for_discriminator: bool):
        x = x.float()
        if self.gan_mode == "original":
            target = torch.full_like(x, 1.0 if target_is_real else 0.0)
            return F.binary_cross_entropy_with_logits(x, target)
        if self.gan_mode == "ls":
            return ((x - (1.0 if target_is_real else 0.0)) ** 2).mean()
        if self.gan_mode == "hinge":
            if for_discriminator:
                if target_is_real:
                    return -torch.clamp(x - 1, max=0.0).mean()
                return -torch.clamp(-x - 1, max=0.0).mean()
            if not target_is_real:
                raise ValueError("the hinge G loss is defined toward the real target only")
            return -x.mean()
        return -x.mean() if target_is_real else x.mean()  # wgan

    def __call__(self, pred, target_is_real: bool, for_discriminator: bool = True):
        """``pred``: a tensor, a list of tensors, or a list of per-D feature
        lists (the multiscale D), whose last entry is the logits; the
        losses of a list are averaged."""
        if isinstance(pred, (list, tuple)):
            total = 0.0
            for pred_i in pred:
                if isinstance(pred_i, (list, tuple)):
                    pred_i = pred_i[-1]
                total = total + self._loss(pred_i, target_is_real, for_discriminator)
            return total / len(pred)
        return self._loss(pred, target_is_real, for_discriminator)


class VGGLoss:
    """The 5-slice VGG19 perceptual L1 with weights 1/32, 1/16, 1/8, 1/4, 1
    (loss.py:106-122) between two [-1, 1] NHWC images. The target's
    features carry no gradient; each L1 is taken in f32."""

    WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

    def __init__(self, model: Vgg19Features, layids: Optional[Sequence[int]] = None):
        self.model = model
        self.layids = layids

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.model(x)
        with torch.no_grad():
            fy = self.model(y)
        layids = self.layids if self.layids is not None else range(len(fx))
        loss = 0.0
        for i in layids:
            loss = loss + self.WEIGHTS[i] * (fx[i].float() - fy[i].float()).abs().mean()
        return loss


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().mean()
