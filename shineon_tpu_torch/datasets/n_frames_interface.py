"""Video clips of n frames (counterpart of
shineon_tpu/datasets/n_frames_interface.py; reference
datasets/n_frames_interface.py:12-138).

``NFramesInterface.return_n_frames`` turns one index into a clip: the
wrapped ``__getitem__`` runs for each index ``collect_n_frames_indices``
gives, and :func:`collate_frames` stacks the arrays on a new leading frames
axis. ``fold_frames_into_channels`` folds (..., N, H, W, C) into
(..., H, W, N*C), frame-major, for the frame-stacked conv models.
"""

from __future__ import annotations

import functools
from abc import ABC, abstractmethod
from argparse import ArgumentParser
from typing import Dict, List

import numpy as np


class NFramesInterface(ABC):
    @staticmethod
    def modify_commandline_options(parser: ArgumentParser, is_train: bool):
        parser.add_argument(
            "--n_frames_total", type=int, default=1, metavar="N",
            help="Total number of frames to load at once (1 for images).",
        )
        parser.add_argument(
            "--n_frames_now", type=int, default=None, metavar="N",
            help="Progressive video training: train on the last n_frames_now "
            "frames of the clip, masking earlier ones to zero.",
        )
        return parser

    @staticmethod
    def apply_n_frames_now_default_total(opt):
        """An unset ``n_frames_now`` is ``n_frames_total``."""
        if getattr(opt, "n_frames_now", None) is None and hasattr(opt, "n_frames_total"):
            opt.n_frames_now = opt.n_frames_total
        return opt

    def __init__(self, opt):
        self.n_frames_total = opt.n_frames_total
        self.n_frames_now = opt.n_frames_now
        if self.n_frames_total < 1:
            raise ValueError("n_frames_total must be a positive integer")
        if self.n_frames_now > self.n_frames_total:
            raise ValueError(f"n_frames_now {opt.n_frames_now} > n_frames_total "
                             f"{opt.n_frames_total}")

    @abstractmethod
    def collect_n_frames_indices(self, index: int) -> List[int]:
        """Indices of the clip ending at ``index``."""

    @staticmethod
    def return_n_frames(getitem_func):
        @functools.wraps(getitem_func)
        def wrapper(self, index):
            indices = self.collect_n_frames_indices(index)
            assert len(indices) == self.n_frames_total, (
                f"{len(indices)=} doesn't match {self.n_frames_total=}")
            return collate_frames([getitem_func(self, i) for i in indices])

        return wrapper


def collate_frames(frames: List[Dict]) -> Dict:
    """Per-frame sample dicts -> one dict, arrays stacked on a new leading
    frames axis, anything else listed."""
    out: Dict = {}
    for key in frames[0]:
        vals = [f[key] for f in frames]
        if isinstance(vals[0], str):
            out[key] = vals
        elif isinstance(vals[0], (np.ndarray, np.floating, np.integer, float, int)):
            out[key] = np.stack([np.asarray(v) for v in vals], axis=0)
        else:
            out[key] = vals
    return out


def maybe_combine_frames_and_channels(opt, inputs: Dict, has_batch_dim: bool = True) -> Dict:
    """Fold the frames axis of each array with one more axis than an image
    into its channels; unpack one-element lists when ``n_frames_total`` is
    1 (reference n_frames_interface.py:105-138)."""
    if not hasattr(opt, "n_frames_total"):
        return inputs
    base = 4 if has_batch_dim else 3

    def maybe_combine(value):
        if hasattr(value, "ndim") and hasattr(value, "reshape"):
            return fold_frames_into_channels(value) if value.ndim == base + 1 else value
        if isinstance(value, (list, tuple)) and opt.n_frames_total == 1:
            return value[0]
        return value

    return {k: maybe_combine(v) for k, v in inputs.items()}


def fold_frames_into_channels(value):
    """(..., N, H, W, C) -> (..., H, W, N*C), frame-major channels; a torch
    tensor or a numpy array."""
    if isinstance(value, np.ndarray):
        value = np.moveaxis(value, -4, -2)
    else:
        value = value.movedim(-4, -2)
    return value.reshape(value.shape[:-2] + (-1,))
