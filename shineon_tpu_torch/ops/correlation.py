"""Global all-pairs correlation of the GMM (counterpart of
shineon_tpu/ops/correlation.py::global_correlation)."""

from __future__ import annotations

import torch


def global_correlation(feature_a: torch.Tensor, feature_b: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) x (B, H, W, C) -> (B, H, W, H*W): position (h, w) holds
    the dot products of feature_b[h, w] with every location of feature_a,
    channel k = x_A * H + y_A (reference warp.py:59-66). Computed in f32;
    the result has feature_a's dtype."""
    B, H, W, C = feature_a.shape
    a = feature_a.permute(0, 2, 1, 3).reshape(B, W * H, C).float()
    b = feature_b.reshape(B, H * W, C).float()
    corr = torch.bmm(b, a.transpose(1, 2))
    return corr.reshape(B, H, W, W * H).to(feature_a.dtype)
