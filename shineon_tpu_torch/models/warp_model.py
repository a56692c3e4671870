"""GMM warp stage at eval (counterpart of shineon_tpu/models/warp_model.py:44-57)."""

from __future__ import annotations

import torch

from shineon_tpu_torch.models.sams_model import channels_of, compute_dtype_of
from shineon_tpu_torch.networks.cpvton.warp import GMM
from shineon_tpu_torch.networks.init import normal_
from shineon_tpu_torch.networks.layers import Conv2d, Dense
from shineon_tpu_torch.networks.normalization import SyncBatchNorm


class WarpModel:
    """Owns the GMM at the options' fine size, grid size and width."""

    def __init__(self, opt, device="cuda"):
        self.opt = opt
        self.compute_dtype = compute_dtype_of(opt)
        self.gmm = GMM(
            channels_of(opt.person_inputs), channels_of(opt.cloth_inputs),
            fine_height=opt.fine_height, fine_width=opt.fine_width,
            grid_size=opt.grid_size, ngf=opt.ngf, dtype=self.compute_dtype,
        ).to(device)

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
