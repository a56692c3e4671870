"""The n-frames layout helper the SAMS training step needs (counterpart of
shineon_tpu/datasets/n_frames_interface.py::fold_frames_into_channels)."""

from __future__ import annotations

import torch


def fold_frames_into_channels(value: torch.Tensor) -> torch.Tensor:
    """(..., N, H, W, C) -> (..., H, W, N*C), frame-major channels."""
    value = value.movedim(-4, -2)
    return value.reshape(value.shape[:-2] + (-1,))
