"""Correlation ops (counterpart of shineon_tpu/ops/correlation.py): the
GMM's global all-pairs correlation and FlowNetC's windowed cost volume."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def cost_volume(feature1: torch.Tensor, feature2: torch.Tensor,
                max_displacement: int = 4, stride: int = 1) -> torch.Tensor:
    """Local correlation cost volume (flownet2's Correlation, kernel size 1):
    (B, H, W, C) x (B, H, W, C) -> (B, H, W, D*D) over the displacements
    -md, -md + stride, ..., md on each axis (D = 2*(md // stride) + 1 when
    stride divides md: 441 channels at FlowNetC's md 20, stride 2). Channel
    i * D + j is the channel mean of feature1 * feature2 shifted by (dy, dx)
    = (-md + i*stride, -md + j*stride), feature2 zero-padded by md on each
    side; channels are row-major over (dy, dx). Products are summed in f32;
    the result has feature1's dtype.

    One displacement row dy at a time: the D windows along x are a strided
    view of the padded row band, so the working set is one (B, H, W, D, C)
    product, never the (B, H, W, D*D, C) volume. A call launches a
    multiply and a sum per row, plus the pad, the stack and the division
    (and casts for inputs that are not f32)."""
    B, H, W, C = feature1.shape
    md, s = max_displacement, stride
    D = len(range(-md, md + 1, s))
    f1 = feature1.float()[:, :, :, None, :]  # (B, H, W, 1, C)
    padded = F.pad(feature2.float(), (0, 0, md, md, md, md))  # (B, H+2md, W+2md, C)
    rows = []
    for i in range(D):
        band = padded[:, i * s:i * s + H]  # row y + md + dy of the padded map
        windows = band.unfold(2, W, s).permute(0, 1, 4, 2, 3)  # (B, H, W, D, C)
        rows.append(torch.sum(f1 * windows, dim=-1))
    out = torch.stack(rows, dim=3).reshape(B, H, W, D * D) / C
    return out.to(feature1.dtype)
