"""On-device image preprocessing ops (counterpart of shineon_tpu/ops/image_ops.py).

All ops take raw uint8 images / label maps as tensors with any leading dims
and return the reference's normalized [-1, 1] features in NHWC layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# LIP 20-class human-parse labels (reference: datasets/tryon_dataset.py:21-41).
LIP_BACKGROUND = 0
LIP_HAT = 1
LIP_HAIR = 2
LIP_GLOVE = 3
LIP_SUNGLASSES = 4
LIP_UPPER_CLOTHES = 5
LIP_DRESS = 6
LIP_COAT = 7
LIP_SOCKS = 8
LIP_PANTS = 9
LIP_JUMPSUITS = 10
LIP_SCARF = 11
LIP_SKIRT = 12
LIP_FACE = 13
LIP_LEFT_ARM = 14
LIP_RIGHT_ARM = 15
LIP_LEFT_LEG = 16
LIP_RIGHT_LEG = 17
LIP_LEFT_SHOE = 18
LIP_RIGHT_SHOE = 19

# Labels of the "head" crop (tryon_dataset.py:323-344: despite the name it
# includes socks/pants/scarf/skirt/legs/shoes).
HEAD_LABELS = (
    LIP_HAT, LIP_HAIR, LIP_SUNGLASSES, LIP_FACE, LIP_SOCKS, LIP_PANTS,
    LIP_SCARF, LIP_SKIRT, LIP_LEFT_LEG, LIP_RIGHT_LEG, LIP_LEFT_SHOE,
    LIP_RIGHT_SHOE,
)
# Labels of the worn-cloth segment (datasets/util.py:6-22).
CLOTH_LABELS = (LIP_UPPER_CLOTHES, LIP_DRESS, LIP_COAT)


def normalize_rgb(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [-1,1] (ToTensor + Normalize(0.5, 0.5))."""
    return img_u8.to(torch.float32) / 127.5 - 1.0


def denormalize_to_uint8(img: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8, rounded half to even (the export's save path,
    visualization.py:74-76 of the reference)."""
    return torch.round(torch.clamp((img.float() + 1.0) * 0.5 * 255.0, 0, 255)).to(torch.uint8)


def cloth_mask_from_image(
    cloth_u8: torch.Tensor, threshold: int = 240, reference_quirk: bool = False
) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., H, W, 1) mask: 0 where the red channel
    is >= threshold (white background), else 1. ``reference_quirk``
    compares the normalized tensor instead, which gives all ones."""
    red = cloth_u8[..., :1]
    red = normalize_rgb(red) if reference_quirk else red.to(torch.float32)
    return torch.where(red >= threshold, 0.0, 1.0)


def _linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) weights of an antialiased linear (triangle
    kernel) resize with half-pixel centres, as jax.image.resize(method=
    "linear", antialias=True) computes them: the kernel widens by the
    downscale factor and each column is normalised to sum to one."""
    f32 = np.float32
    inv = f32(in_size / out_size)
    kernel_scale = max(inv, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Separable antialiased linear resize over the trailing (H, W) axes."""
    wy = torch.from_numpy(_linear_resize_matrix(img.shape[-2], out_h)).to(img.device)
    wx = torch.from_numpy(_linear_resize_matrix(img.shape[-1], out_w)).to(img.device)
    out = torch.einsum("...hw,hy->...yw", img, wy)
    return torch.einsum("...yw,wx->...yx", out, wx)


def body_silhouette(parse: torch.Tensor, fine_height: int = 256,
                    fine_width: int = 192) -> torch.Tensor:
    """Blurry body silhouette in [-1, 1]: (parse > 0) * 255, antialiased
    bilinear down 16x and back up, with the uint8 rounding of each stage
    (tryon_dataset.py:346-367). (..., H, W) -> (..., H, W, 1)."""
    sil = (parse > 0).to(torch.float32) * 255.0
    down = _resize_linear(sil, fine_height // 16, fine_width // 16)
    down = torch.clamp(torch.round(down), 0.0, 255.0)
    up = _resize_linear(down, parse.shape[-2], parse.shape[-1])
    up = torch.clamp(torch.round(up), 0.0, 255.0)
    return (up / 127.5 - 1.0)[..., None]


def _label_mask(parse: torch.Tensor, labels) -> torch.Tensor:
    mask = torch.zeros(parse.shape, dtype=torch.float32, device=parse.device)
    for label in labels:
        mask = mask + (parse == label).to(torch.float32)
    return mask[..., None]


def head_crop(image: torch.Tensor, parse: torch.Tensor) -> torch.Tensor:
    """Head(+extremities) pixels of the person image, background -1."""
    mask = _label_mask(parse, HEAD_LABELS)
    return image * mask - (1.0 - mask)


def segment_cloths_from_image(image: torch.Tensor, parse: torch.Tensor) -> torch.Tensor:
    """Worn-cloth pixels of the person image, background +1."""
    mask = _label_mask(parse, CLOTH_LABELS)
    return image * mask + (1.0 - mask)


def normalize_flow(flow: torch.Tensor) -> torch.Tensor:
    """Affine flow normalization (x - 0.5) / 0.5."""
    return flow * 2.0 - 1.0


def channel_norm(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-pixel L2 norm over the trailing channel axis, in f32 (flownet2's
    ChannelNorm): (..., C) -> (..., 1)."""
    return torch.sqrt(torch.sum(x.float() ** 2, dim=-1, keepdim=True) + eps)


def resize_bilinear(x: torch.Tensor, size) -> torch.Tensor:
    """Resize an NHWC tensor to ``size`` = (H', W') as
    ``jax.image.resize(method="linear")`` does: a triangle kernel on
    half-pixel centres, widened by the scale when it downsamples
    (antialiased), with the weights renormalised at the borders (which,
    upsampling, is PyTorch's clamp of the source coordinate to the edge).
    An axis whose size does not change is left untouched. f32 result.
    Unlike ``_resize_linear``, which builds JAX's own weights on the host
    (the silhouette's uint8 rounding needs them: this resize's last-bit
    differences flip its rounding), it is one device call, agreeing with
    JAX to f32 rounding."""
    x = x.float()
    if tuple(size) == tuple(x.shape[1:3]):
        return x
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def pose_keypoint_heatmaps(keypoints: torch.Tensor, fine_height: int = 256,
                           fine_width: int = 192, radius: int = 5):
    """COCO keypoints (..., K, 3) of (x, y, confidence) in pixels -> the
    K-channel square-stamp heatmaps (..., H, W, K) and their union
    ``im_cocopose`` (..., H, W, 1), both -1 (background) / +1 (stamp).

    Each joint is the filled square PIL draws for the rectangle (x-r, y-r,
    x+r, y+r): pixels p with floor(x-r) <= p <= floor(x+r) on each axis
    (tryon_dataset.py:369-448). Joints with x <= 1 or y <= 1 are skipped.
    Like the JAX package, every channel is its joint's stamp: the
    reference's pose-map channels come out constant (it copies each map
    before drawing it), which is not followed."""
    x, y = keypoints[..., 0], keypoints[..., 1]  # (..., K)
    valid = (x > 1) & (y > 1)
    dev = keypoints.device
    px = torch.arange(fine_width, dtype=torch.float32, device=dev)
    py = torch.arange(fine_height, dtype=torch.float32, device=dev)
    x0, x1 = torch.floor(x - radius), torch.floor(x + radius)
    y0, y1 = torch.floor(y - radius), torch.floor(y + radius)
    in_x = (px >= x0[..., None]) & (px <= x1[..., None])  # (..., K, W)
    in_y = (py >= y0[..., None]) & (py <= y1[..., None]) & valid[..., None]  # (..., K, H)
    inside = in_y[..., :, None] & in_x[..., None, :]  # (..., K, H, W)
    pose_map = torch.where(inside, 1.0, -1.0).movedim(-3, -1)
    vis = torch.where(inside.any(dim=-3), 1.0, -1.0)[..., None]
    return pose_map, vis
