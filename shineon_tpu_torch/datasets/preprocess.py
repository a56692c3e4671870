"""Device feature factory: raw uint8/float batch -> model feature dict
(counterpart of shineon_tpu/datasets/preprocess.py).

Keys and shapes mirror the JAX package: NHWC, frames as a leading
per-sample axis, float32 features.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from shineon_tpu_torch.ops import image_ops


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Static preprocessing plan derived from the options."""

    fine_height: int = 256
    fine_width: int = 192
    radius: int = 5
    cloth_mask_threshold: int = 240
    person_inputs: Tuple[str, ...] = ("agnostic", "cocopose")
    cloth_inputs: Tuple[str, ...] = ("cloth",)
    visualize_flow: bool = False
    cloth_mask_reference_quirk: bool = False

    @classmethod
    def from_opt(cls, opt) -> "PreprocessConfig":
        return cls(
            fine_height=opt.fine_height,
            fine_width=opt.fine_width,
            radius=opt.radius,
            cloth_mask_threshold=opt.cloth_mask_threshold,
            person_inputs=tuple(opt.person_inputs),
            cloth_inputs=tuple(opt.cloth_inputs),
            visualize_flow=bool(getattr(opt, "visualize_flow", False)),
        )


def _per_sample(valid: torch.Tensor) -> torch.Tensor:
    """(..., ) validity flags -> broadcastable over (..., H, W, C)."""
    return valid[..., None, None, None]


def preprocess_batch(raw: Dict[str, torch.Tensor], config: PreprocessConfig):
    """Raw batch (any leading dims) -> normalized feature dict.

    Produced keys (as applicable): image, prev_image, cloth, cloth_mask,
    silhouette, im_head, im_cloth, agnostic, cocopose, im_cocopose,
    densepose, flow, flow_image, grid_vis.
    """
    cfg = config
    out: Dict[str, torch.Tensor] = {}

    image = image_ops.normalize_rgb(raw["image_u8"])
    out["image"] = image
    prev = image_ops.normalize_rgb(raw["prev_image_u8"])
    # missing prev frame -> zeros in normalized space
    out["prev_image"] = prev * _per_sample(raw["prev_image_valid"])

    out["cloth"] = image_ops.normalize_rgb(raw["cloth_u8"])
    out["cloth_mask"] = image_ops.cloth_mask_from_image(
        raw["cloth_u8"], cfg.cloth_mask_threshold,
        reference_quirk=cfg.cloth_mask_reference_quirk,
    )

    parse = raw["parse_u8"]
    silhouette = image_ops.body_silhouette(parse, cfg.fine_height, cfg.fine_width)
    im_head = image_ops.head_crop(image, parse)
    out["silhouette"] = silhouette
    out["im_head"] = im_head
    out["im_cloth"] = image_ops.segment_cloths_from_image(image, parse)

    if "agnostic" in cfg.person_inputs:
        # [silhouette, im_head] channel order (tryon_dataset.py:225-228)
        out["agnostic"] = torch.cat([silhouette, im_head], dim=-1)

    if "cocopose" in cfg.person_inputs:
        out["cocopose"], out["im_cocopose"] = image_ops.pose_keypoint_heatmaps(
            raw["cocopose_kp"], cfg.fine_height, cfg.fine_width, cfg.radius)

    if "densepose" in cfg.person_inputs:
        dp = image_ops.normalize_rgb(raw["densepose_u8"])
        out["densepose"] = dp * _per_sample(raw["densepose_valid"])

    if "flow_raw" in raw:
        flow = image_ops.normalize_flow(raw["flow_raw"])
        # missing flow -> zeros WITHOUT normalization
        out["flow"] = flow * _per_sample(raw["flow_valid"])
        if cfg.visualize_flow and "flow_image_u8" in raw:
            out["flow_image"] = image_ops.normalize_rgb(raw["flow_image_u8"])

    if "grid_vis_u8" in raw:
        out["grid_vis"] = image_ops.normalize_rgb(raw["grid_vis_u8"])

    return out
