"""GMM warp model: the serving clip's warp stage and the GMM's training,
validation and visual steps (counterpart of shineon_tpu/models/warp_model.py).

The step: device features -> GMM (batch statistics, the running ones
updated, as flax's ``mutable=["batch_stats"]``) -> TPS grid -> border
``grid_sample`` of the cloth -> L1 to ``im_cloth`` -> Adam. The gradient
reaches theta through ``grid_sample``'s backward (the JAX package's VJP)
and the TPS basis products.
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Dict

import torch

from shineon_tpu_torch.models.base_model import (
    BaseModel,
    get_and_cat_inputs,
    gradients,
    to_numpy,
)
from shineon_tpu_torch.networks.cpvton.warp import GMM
from shineon_tpu_torch.networks.init import normal_
from shineon_tpu_torch.networks.layers import Conv2d, Dense
from shineon_tpu_torch.networks.loss import l1_loss
from shineon_tpu_torch.networks.normalization import SyncBatchNorm
from shineon_tpu_torch.ops import grid_sample
from shineon_tpu_torch.training.state import TrainState
from shineon_tpu_torch.utils.visualization import get_save_paths, save_images


class WarpModel(BaseModel):
    """Owns the GMM at the options' fine size, grid size and width."""

    @classmethod
    def modify_commandline_options(cls, parser: argparse.ArgumentParser, is_train):
        parser = argparse.ArgumentParser(parents=[parser], add_help=False)
        parser = super().modify_commandline_options(parser, is_train)
        parser.add_argument("--grid_size", type=int, default=5)
        parser.set_defaults(person_inputs=("agnostic", "cocopose"))
        return parser

    def __init__(self, opt, device="cuda"):
        super().__init__(opt, device)
        self.gmm = GMM(
            self.person_channels, self.cloth_channels,
            fine_height=opt.fine_height, fine_width=opt.fine_width,
            grid_size=opt.grid_size, ngf=opt.ngf, dtype=self.compute_dtype,
        ).to(self.device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, gain: float = 0.02):
        """CP-VTON rule: conv and dense weights ~ N(0, gain), zero biases,
        batch-norm scales ~ N(1, gain). Drawn on the CPU, then copied."""
        for m in self.gmm.modules():
            if isinstance(m, (Conv2d, Dense)):
                m.weight.copy_(normal_(torch.empty(m.weight.shape), gain, generator))
                m.bias.zero_()
            elif isinstance(m, SyncBatchNorm):
                m.weight.copy_(normal_(torch.empty(m.weight.shape), gain, generator, mean=1.0))
                m.bias.zero_()

    def init_state(self, generator: torch.Generator, steps_per_epoch: int) -> TrainState:
        """The GMM's weights from ``generator``, then :meth:`make_state`."""
        self.init_weights(generator)
        return self.make_state(steps_per_epoch)

    def make_state(self, steps_per_epoch: int) -> TrainState:
        """Step 0 and Adam at ``lr`` over the GMM's current weights."""
        return TrainState(nets={"gmm": self.net_state(self.gmm, getattr(self.opt, "lr", 1e-4),
                                                      steps_per_epoch)})

    def forward_loss(self, feats: Dict[str, torch.Tensor], train: bool):
        """(loss, grid, theta, warped_cloth): with ``train`` the GMM's norms
        take batch statistics and update their running ones."""
        person = get_and_cat_inputs(feats, self.opt.person_inputs)
        cloth_in = get_and_cat_inputs(feats, self.opt.cloth_inputs)
        grid, theta = self.gmm(person, cloth_in, train=train)
        warped_cloth = grid_sample(feats["cloth"], grid, padding_mode="border")
        return l1_loss(warped_cloth, feats["im_cloth"]), grid, theta, warped_cloth

    def make_train_step(self):
        """``step(state, raw_batch) -> metrics``, updating ``state`` in place."""

        def train_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            feats = self.features(raw_batch)
            net = state.nets["gmm"]
            lr = net.optimizer.schedule(state.step)
            loss, *_ = self.forward_loss(feats, train=True)
            net.optimizer.step(gradients(loss, net.optimizer.params))
            state.step += 1
            return {"loss/G": loss.detach(), "lr": lr}

        return train_step

    def make_val_step(self):
        """``step(state, raw_batch) -> metrics``: the loss in eval mode;
        ``checkpoint_on`` is the loss."""

        @torch.no_grad()
        def val_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            loss, *_ = self.forward_loss(self.features(raw_batch), train=False)
            return {"loss/G": loss, "checkpoint_on": loss}

        return val_step

    def make_visual_step(self):
        """``step(state, raw_batch) -> tensors``: the warped cloth, the grid
        image warped with zeros padding (``warped_grid``), and the inputs
        that are displayed."""

        @torch.no_grad()
        def visual_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            feats = self.features(raw_batch)
            _, grid, _, warped_cloth = self.forward_loss(feats, train=False)
            out = {
                "warped_cloth": warped_cloth,
                "warped_grid": grid_sample(feats["grid_vis"], grid, padding_mode="zeros"),
                "cloth": feats["cloth"],
                "im_cloth": feats["im_cloth"],
                "image": feats["image"],
            }
            for name in ("silhouette", "im_head", "im_cocopose", "densepose"):
                if name in feats:
                    out[name] = feats[name]
            return out

        return visual_step

    def visual_rows(self, v):
        """The board grid (warp_model.py:100-113 of the reference)."""
        return [
            self.fetch_person_visuals(v),
            [v["cloth"], v["warped_cloth"], v["im_cloth"]],
            [v["warped_grid"], (v["warped_cloth"] + v["image"]) * 0.5, v["image"]],
        ]

    @torch.no_grad()
    def test_step(self, state: TrainState, device_batch, host_batch) -> None:
        """Warp the batch and write ``warp-cloth/`` and ``warp-mask/`` PNGs
        under each sample's dataset name; a batch whose cloths all exist
        is skipped, and so is each file that exists (warp_model.py:174-)."""
        cloth_dirs, names = self.export_targets(host_batch, "cloth_name", "warp-cloth")
        mask_dirs, _ = self.export_targets(host_batch, "cloth_name", "warp-mask")
        if all(osp.exists(p) for p in get_save_paths(cloth_dirs, names)):
            return
        feats = self.features(device_batch)
        _, grid, _, warped_cloth = self.forward_loss(feats, train=False)
        warped_mask = grid_sample(feats["cloth_mask"], grid, padding_mode="zeros")
        save_images(to_numpy(warped_cloth), names, cloth_dirs)
        save_images(to_numpy(warped_mask) * 2 - 1, names, mask_dirs)
