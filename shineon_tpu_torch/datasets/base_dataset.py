"""Abstract dataset base (counterpart of shineon_tpu/datasets/base_dataset.py;
reference datasets/base_dataset.py:7-47): a map-style source of numpy raw
sample dicts. Batching and prefetch are :mod:`.loader`'s; the normalized
features are made on the device (:mod:`.preprocess`)."""

from __future__ import annotations

import argparse
from abc import ABC, abstractmethod


class BaseDataset(ABC):
    @staticmethod
    def modify_commandline_options(parser: argparse.ArgumentParser, is_train: bool):
        """Add the dataset's options to the command line (none here)."""
        return parser

    def __init__(self, opt):
        self.opt = opt

    @abstractmethod
    def __len__(self) -> int:
        return 0

    @abstractmethod
    def __getitem__(self, index: int):
        pass
