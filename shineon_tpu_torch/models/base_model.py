"""What the port's models share (counterpart of
shineon_tpu/models/base_model.py): the compute dtype, the person and cloth
channel counts, the device features, and the optimizer and schedule set-up.

A model is built for one device (``cuda`` unless the caller says ``cpu``)
and its training state is updated in place by its steps:

* ``init_state(generator, steps_per_epoch) -> TrainState``
* ``make_train_step() -> step(state, raw_batch) -> metrics``
* ``make_val_step() -> step(state, raw_batch) -> metrics`` (eval-mode norms,
  no gradient; ``checkpoint_on`` is the value a checkpoint is chosen by)
* ``make_visual_step() -> step(state, raw_batch) -> tensors to display``
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from shineon_tpu_torch.datasets.channels import channels_for
from shineon_tpu_torch.datasets.n_frames_interface import fold_frames_into_channels
from shineon_tpu_torch.datasets.preprocess import PreprocessConfig, preprocess_batch
from shineon_tpu_torch.training.optimizers import make_optimizer
from shineon_tpu_torch.training.state import NetState


def compute_dtype_of(opt) -> Optional[torch.dtype]:
    """``precision 16`` runs the networks in bf16 while parameters stay f32;
    flows, sampling grids, norm statistics and the losses stay f32."""
    return torch.bfloat16 if getattr(opt, "precision", 32) == 16 else None


def channels_of(names) -> int:
    return sum(channels_for(n) for n in names)


def get_and_cat_inputs(feats: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """The named features concatenated on the channel (last) axis."""
    return torch.cat([feats[name] for name in names], dim=-1)


class BaseModel:
    def __init__(self, opt, device="cuda"):
        self.opt = opt
        self.device = torch.device(device)
        self.n_frames_total = getattr(opt, "n_frames_total", 1)
        self.person_channels = channels_of(opt.person_inputs)
        self.cloth_channels = channels_of(opt.cloth_inputs)
        self.compute_dtype = compute_dtype_of(opt)
        self.preprocess_config = PreprocessConfig.from_opt(opt)

    def features(self, raw_batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The device features, frames folded into channels (frame-major)
        for the frame-stacked conv models."""
        feats = preprocess_batch(raw_batch, self.preprocess_config)
        return {k: fold_frames_into_channels(v) if v.dim() == 5 else v
                for k, v in feats.items()}

    def net_state(self, module: torch.nn.Module, lr: float, steps_per_epoch: int) -> NetState:
        """``module`` with optax's Adam at ``lr`` on the keep/decay schedule."""
        opt = self.opt
        return NetState(module, make_optimizer(
            module.parameters(), lr, opt.keep_epochs, opt.decay_epochs, steps_per_epoch,
            opt.accumulated_batches))


def gradients(loss: torch.Tensor, params):
    """d loss / d params, zeros for a parameter the loss does not reach;
    no ``.grad`` is written."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
