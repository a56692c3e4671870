"""Train state (counterpart of shineon_tpu/training/state.py): the step
count and, for each optimized network, the module (its parameters, and its
buffers as the statistics: running means and variances, spectral ``u`` and
``sigma``) with its optimizer. Updated in place by the train step."""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

from torch import nn

from shineon_tpu_torch.training.optimizers import Adam, MultiSteps


@dataclasses.dataclass
class NetState:
    module: nn.Module
    optimizer: Union[Adam, MultiSteps]


@dataclasses.dataclass
class TrainState:
    nets: Dict[str, NetState]
    step: int = 0
