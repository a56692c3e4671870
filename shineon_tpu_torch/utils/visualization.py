"""Board image grids and PNG export (counterpart of
shineon_tpu/utils/visualization.py; reference visualization.py:7-88), on
numpy NHWC arrays: [-1, 1] -> [0, 1] on a canvas filled with 0.5, one-channel
masks repeated to RGB, and a batch PNG writer that skips files that exist
(a test run resumes) and the warp-mask tree outside VitonDataset."""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np
from PIL import Image


def tensor_for_board(img: np.ndarray) -> np.ndarray:
    """(B, H, W, C) in [-1, 1] -> float [0, 1], masks -> RGB."""
    assert img.ndim == 4, f"not a standard img tensor: {img.shape=}"
    tensor = np.clip((np.asarray(img, np.float32) + 1.0) * 0.5, 0.0, 1.0)
    if tensor.shape[-1] == 1:
        tensor = np.repeat(tensor, 3, axis=-1)
    return tensor


def tensor_list_for_board(img_tensors_list: Sequence[Sequence]) -> np.ndarray:
    """Rows of (B, H, W, C) images -> one (B, rows H, columns W, 3) canvas."""
    grid_h = len(img_tensors_list)
    grid_w = max(len(row) for row in img_tensors_list)
    batch_size, height, width, channel = tensor_for_board(
        np.asarray(img_tensors_list[0][0])).shape
    canvas = np.full((batch_size, grid_h * height, grid_w * width, channel), 0.5, np.float32)
    for i, row in enumerate(img_tensors_list):
        for j, img in enumerate(row):
            canvas[:, i * height:(i + 1) * height, j * width:(j + 1) * width] = \
                tensor_for_board(np.asarray(img))
    return canvas


def board_add_images(board, tag_name: str, img_tensors_list, step_count: int):
    """One image a sample, ``{tag}/{i:03d}``, HWC."""
    for i, img in enumerate(tensor_list_for_board(img_tensors_list)):
        board.add_image(f"{tag_name}/{i:03d}", img, step_count, dataformats="HWC")


def get_save_paths(save_dirs: List[str], img_names: List[str]) -> List[str]:
    return [os.path.join(s, i) for s, i in zip(save_dirs, img_names)]


def save_images(img_tensors, img_names: List[str], save_dirs) -> None:
    """Write a batch of [-1, 1] NHWC images as PNGs, through PIL; a file
    that exists is skipped, and so is a warp-mask tree outside VitonDataset."""
    if isinstance(save_dirs, str):
        save_dirs = [save_dirs] * len(img_names)
    elif len(save_dirs) == 1:
        save_dirs = list(save_dirs) * len(img_names)
    for img, img_name, save_dir in zip(np.asarray(img_tensors), img_names, save_dirs):
        if "warp-mask" in save_dir and "VitonDataset" not in save_dir:
            continue
        path = os.path.join(save_dir, img_name)
        if os.path.exists(path):
            continue
        out = np.clip((img.astype(np.float32) + 1.0) * 0.5 * 255.0, 0, 255).astype(np.uint8)
        if out.shape[-1] == 1:
            out = out[..., 0]
        elif out.shape[-1] != 3:
            raise ValueError(f"image must have 1 or 3 channels, got {out.shape=}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(out).save(path)
