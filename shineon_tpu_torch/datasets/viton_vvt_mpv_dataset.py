"""VITON, VVT and MPV concatenated, indices offset in that order
(counterpart of shineon_tpu/datasets/viton_vvt_mpv_dataset.py; reference
datasets/viton_vvt_mpv_dataset.py:15-65); validation from VVT only."""

from __future__ import annotations

from argparse import ArgumentParser

from shineon_tpu_torch.datasets.base_dataset import BaseDataset
from shineon_tpu_torch.datasets.mpv_dataset import MPVDataset
from shineon_tpu_torch.datasets.n_frames_interface import maybe_combine_frames_and_channels
from shineon_tpu_torch.datasets.viton_dataset import VitonDataset
from shineon_tpu_torch.datasets.vvt_dataset import VVTDataset


class VitonVvtMpvDataset(BaseDataset):
    @staticmethod
    def modify_commandline_options(parser: ArgumentParser, is_train: bool):
        parser = VVTDataset.modify_commandline_options(parser, is_train)
        parser = VitonDataset.modify_commandline_options(parser, is_train, shared=True)
        parser = MPVDataset.modify_commandline_options(parser, is_train, shared=True)
        return parser

    def __init__(self, opt):
        super().__init__(opt)
        self.viton_dataset = VitonDataset(opt)
        self.vvt_dataset = VVTDataset(opt)
        self.mpv_dataset = MPVDataset(opt)

    @classmethod
    def make_validation_dataset(cls, opt):
        return VVTDataset(opt, i_am_validation=True)

    def __getitem__(self, index: int):
        if index < len(self.viton_dataset):
            return self.viton_dataset[index]
        index -= len(self.viton_dataset)
        if index < len(self.vvt_dataset):
            item = self.vvt_dataset[index]
            if self.opt.model == "warp":
                assert self.opt.n_frames_total == 1, (
                    f"{self.opt.n_frames_total=}; warp model shouldn't use n_frames_total > 1")
                item = maybe_combine_frames_and_channels(self.opt, item, has_batch_dim=False)
            return item
        index -= len(self.vvt_dataset)
        return self.mpv_dataset[index]

    def __len__(self):
        return len(self.viton_dataset) + len(self.vvt_dataset) + len(self.mpv_dataset)
