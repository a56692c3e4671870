"""Compute ops: warping, correlation, TPS, preprocessing and the fused
MultiSPADE chain."""

import torch

from shineon_tpu_torch.ops.correlation import global_correlation  # noqa: F401
from shineon_tpu_torch.ops.grid_sample import affine_grid, grid_sample, resample2d  # noqa: F401
from shineon_tpu_torch.ops.tps import TpsGridGen  # noqa: F401


def feature_l2_norm(feature: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Channelwise L2 normalization over the trailing axis, with the
    reference's sqrt(sum + eps) placement (cpvton/warp.py:39-50)."""
    norm = torch.pow(torch.sum(torch.pow(feature, 2), dim=-1, keepdim=True) + eps, 0.5)
    return feature / norm
