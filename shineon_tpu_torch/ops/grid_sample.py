"""Bilinear grid sampling in NHWC (counterpart of shineon_tpu/ops/grid_sample.py).

The forward is ``F.grid_sample``, which has the JAX package's semantics. The
backward is the JAX package's custom VJP (``_grid_sample_bwd``), not
PyTorch's: in border mode PyTorch counts a source coordinate lying exactly
on the first pixel centre (x = 0 or y = 0) as clipped and gives it a zero
grid gradient, where the JAX VJP keeps the gradient on the closed range
0 <= x <= W - 1. Grids through the first column or row's centres hit this:
``resample2d`` with zero flow at column 0, a TPS grid whose points land
there. (At x = W - 1 both give zero: the corner to its right is the edge
pixel itself.)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """[-1, 1] -> pixel coordinates (torch's grid_sampler_unnormalize)."""
    if align_corners:
        return (coord + 1.0) / 2.0 * (size - 1)
    return ((coord + 1.0) * size - 1.0) / 2.0


def _grid_sample_backward(image, grid, g, padding_mode: str, align_corners: bool):
    """The JAX package's ``_grid_sample_bwd`` in f32: d image is the
    bilinear splat of ``g`` onto the four corners (separable weights,
    out-of-range corners dropped in zeros mode, clamped onto the edge in
    border mode); d grid is ``g`` against the corner differences, zero where
    border mode clipped the coordinate (outside 0 <= x <= W - 1), scaled by
    d(pixel)/d(grid) of ``align_corners``."""
    B, H, W, C = image.shape
    gx_raw = _unnormalize(grid[..., 0], W, align_corners)
    gy_raw = _unnormalize(grid[..., 1], H, align_corners)
    border = padding_mode == "border"
    gx = gx_raw.clamp(0.0, W - 1) if border else gx_raw
    gy = gy_raw.clamp(0.0, H - 1) if border else gy_raw
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    flat_image = image.reshape(B * H * W, C)
    base = (torch.arange(B, device=image.device) * (H * W)).view(B, 1, 1)
    d_image = torch.zeros_like(flat_image)
    values = {}
    for dy, wy in ((0, wy0), (1, wy1)):
        for dx, wx in ((0, wx0), (1, wx1)):
            ix, iy = x0 + dx, y0 + dy
            inside = (ix >= 0) & (ix <= W - 1) & (iy >= 0) & (iy <= H - 1)
            index = base + iy.clamp(0, H - 1).long() * W + ix.clamp(0, W - 1).long()
            index = index.reshape(-1)
            keep = torch.ones_like(inside) if border else inside
            keep = keep.to(g.dtype)[..., None]
            values[dy, dx] = flat_image[index].reshape(g.shape) * keep
            d_image.index_add_(0, index, (g * (wy * wx)[..., None] * keep).reshape(-1, C))
    v00, v01, v10, v11 = values[0, 0], values[0, 1], values[1, 0], values[1, 1]
    d_gx = (g * ((v01 - v00) * wy0[..., None] + (v11 - v10) * wy1[..., None])).sum(-1)
    d_gy = (g * ((v10 - v00) * wx0[..., None] + (v11 - v01) * wx1[..., None])).sum(-1)
    if border:
        zero = torch.zeros_like(d_gx)
        d_gx = torch.where((gx_raw >= 0) & (gx_raw <= W - 1), d_gx, zero)
        d_gy = torch.where((gy_raw >= 0) & (gy_raw <= H - 1), d_gy, zero)
    sx, sy = ((W - 1) / 2.0, (H - 1) / 2.0) if align_corners else (W / 2.0, H / 2.0)
    d_grid = torch.stack([d_gx * sx, d_gy * sy], dim=-1)
    return d_image.reshape(B, H, W, C), d_grid


class _GridSample(torch.autograd.Function):
    """f32 NHWC image and grid; forward ``F.grid_sample``, backward
    :func:`_grid_sample_backward`."""

    @staticmethod
    def forward(ctx, image, grid, padding_mode, align_corners):
        ctx.save_for_backward(image, grid)
        ctx.mode = (padding_mode, align_corners)
        out = F.grid_sample(image.permute(0, 3, 1, 2), grid, mode="bilinear",
                            padding_mode=padding_mode, align_corners=align_corners)
        return out.permute(0, 2, 3, 1)

    @staticmethod
    def backward(ctx, g):
        image, grid = ctx.saved_tensors
        d_image, d_grid = _grid_sample_backward(image, grid, g.contiguous(), *ctx.mode)
        return (d_image if ctx.needs_input_grad[0] else None,
                d_grid if ctx.needs_input_grad[1] else None, None, None)


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """Bilinearly sample ``image`` (B, H, W, C) at ``grid`` (B, Hg, Wg, 2),
    ``grid[..., 0]`` = x (width), ``grid[..., 1]`` = y, both in [-1, 1].
    Sampling and its gradient run in float32; the result has ``image``'s
    dtype."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    out = _GridSample.apply(image.float(), grid.float(), padding_mode, align_corners)
    return out.to(image.dtype)


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
