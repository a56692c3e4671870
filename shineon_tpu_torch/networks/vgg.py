"""VGG19 features for the perceptual loss, NHWC (counterpart of
shineon_tpu/networks/vgg.py; reference models/networks/vgg.py:6-36).

torchvision's VGG19 ``features`` cut into five slices ending at relu1_1,
relu2_1, relu3_1, relu4_1 and relu5_1. Pretrained weights come only from a
local ``.npz`` named by ``SHINEON_VGG19_WEIGHTS``, in the JAX package's
format (``conv{idx}/kernel`` HWIO and ``conv{idx}/bias``). Without it
:func:`load_vgg19` raises unless random filters are asked for
(``allow_random_vgg`` / ``SHINEON_ALLOW_RANDOM_VGG=1``): the reference's
perceptual objective is the ImageNet VGG19 (loss.py:110).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from shineon_tpu_torch import convert
from shineon_tpu_torch.networks.init import lecun_normal_
from shineon_tpu_torch.networks.layers import Conv2d

# conv widths of each slice; a 2x2 max-pool precedes the last conv of
# slices 2-5
SLICE_PLAN = ((64,), (64, 128), (128, 256), (256, 256, 256, 512), (512, 512, 512, 512))
POOL_BEFORE_LAST = (False, True, True, True, True)


class MissingVgg19WeightsError(RuntimeError):
    pass


class Vgg19Features(nn.Module):
    """The five relu activations VGGLoss reads; 3x3 SAME convs with bias
    (``convs.{idx}``, the JAX module's ``conv{idx}``) in the compute
    dtype."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        super().__init__()
        widths = [w for plan in SLICE_PLAN for w in plan]
        self.convs = nn.ModuleList(
            Conv2d(cin, cout, 3, padding=1, dtype=dtype)
            for cin, cout in zip([3] + widths[:-1], widths))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs, idx = [], 0
        for plan, pool_last in zip(SLICE_PLAN, POOL_BEFORE_LAST):
            for j in range(len(plan)):
                if pool_last and j == len(plan) - 1:
                    x = F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
                x = torch.relu(self.convs[idx](x))
                idx += 1
            outs.append(x)
        return outs


def vgg19_weights_path() -> str:
    """Path of the converted ImageNet VGG19 weights, or '' if there are none."""
    path = os.environ.get("SHINEON_VGG19_WEIGHTS", "")
    return path if path and os.path.exists(path) else ""


def load_vgg19(allow_random: bool = False, seed: int = 420,
               dtype: Optional[torch.dtype] = None) -> Vgg19Features:
    """Vgg19Features with the weights of ``$SHINEON_VGG19_WEIGHTS``, frozen,
    on the CPU.

    Without that file it raises :class:`MissingVgg19WeightsError` unless
    ``allow_random`` (or ``SHINEON_ALLOW_RANDOM_VGG=1``) takes fixed random
    filters: lecun-normal kernels and zero biases, flax's defaults, drawn
    from a ``torch.Generator`` seeded with ``seed``. That draw is not the
    JAX package's (its filters come from ``jax.random.PRNGKey(seed)``), so
    the two random objectives differ; parity tests carry the JAX filters
    across with :mod:`shineon_tpu_torch.convert`.
    """
    model = Vgg19Features(dtype=dtype)
    path = vgg19_weights_path()
    if path:
        with np.load(path) as flat:
            params = {}
            for key in flat.files:
                scope, leaf = key.rsplit("/", 1)
                params.setdefault(scope, {})[leaf] = flat[key]
        convert.load_flax(model, {"params": params}, convert.VGG_RENAMES)
    else:
        allowed = allow_random or os.environ.get("SHINEON_ALLOW_RANDOM_VGG", "") not in ("", "0")
        if not allowed:
            raise MissingVgg19WeightsError(
                "No pretrained VGG19 weights found. Point SHINEON_VGG19_WEIGHTS at the "
                ".npz the JAX package's tools/convert_vgg19.py writes, or pass "
                "allow_random_vgg=True (env SHINEON_ALLOW_RANDOM_VGG=1) to knowingly "
                "train against fixed random filters.")
        generator = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for conv in model.convs:
                lecun_normal_(conv.weight, generator)
                conv.bias.zero_()
    return model.requires_grad_(False)
