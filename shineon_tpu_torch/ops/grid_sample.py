"""Bilinear grid sampling in NHWC (counterpart of shineon_tpu/ops/grid_sample.py).

Forward only. The JAX package writes this in XLA (gathers or one-hot
contractions); ``F.grid_sample`` has the same semantics, so the port keeps it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """Bilinearly sample ``image`` (B, H, W, C) at ``grid`` (B, Hg, Wg, 2),
    ``grid[..., 0]`` = x (width), ``grid[..., 1]`` = y, both in [-1, 1].
    Sampling runs in float32; the result has ``image``'s dtype."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    out = F.grid_sample(
        image.permute(0, 3, 1, 2).float(), grid.float(), mode="bilinear",
        padding_mode=padding_mode, align_corners=align_corners,
    )
    return out.permute(0, 2, 3, 1).to(image.dtype)


def resample2d(image: torch.Tensor, flow: torch.Tensor,
               padding_mode: str = "border") -> torch.Tensor:
    """Warp ``image`` (B, H, W, C) by a pixel-unit ``flow`` (B, H, W, 2):
    ``out[b, y, x] = image[b, y + flow_y, x + flow_x]`` (flownet2 Resample2d),
    through the align_corners=True pixel mapping i -> -1 + 2i/(S-1)."""
    B, H, W, C = image.shape
    flow = flow.float()
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=image.device),
        torch.arange(W, dtype=torch.float32, device=image.device),
        indexing="ij",
    )
    gx = xs[None] + flow[..., 0]
    gy = ys[None] + flow[..., 1]
    nx = 2.0 * gx / (W - 1) - 1.0
    ny = 2.0 * gy / (H - 1) - 1.0
    grid = torch.stack([nx, ny], dim=-1)
    return grid_sample(image, grid, padding_mode=padding_mode, align_corners=True)
