"""The MPV folder layout (counterpart of shineon_tpu/datasets/mpv_dataset.py;
reference datasets/mpv_dataset.py:8-86): two poses per cloth, listed in
``all_poseA_poseB_clothes_0607.txt``."""

from __future__ import annotations

import argparse
import os.path as osp

from shineon_tpu_torch.datasets.tryon_dataset import TryonDataset


class MPVDataset(TryonDataset):
    @staticmethod
    def modify_commandline_options(parser: argparse.ArgumentParser, is_train: bool,
                                   shared: bool = False):
        """``shared``: the try-on options are already on the parser."""
        if not shared:
            parser = TryonDataset.modify_commandline_options(parser, is_train)
        parser.add_argument("--mpv_dataroot", default="/data_hdd/mpv_competition")
        return parser

    def load_file_paths(self, i_am_validation: bool = False):
        self.root = self.opt.mpv_dataroot
        self.image_names, self.cloth_names = [], []
        with open(osp.join(self.root, "all_poseA_poseB_clothes_0607.txt"), "r") as f:
            for line in f.readlines():
                person_1, person_2, cloth_name, _ = line.strip().split()
                self.image_names.extend([person_1, person_2])
                self.cloth_names.extend([cloth_name, cloth_name])

    def get_input_cloth_path(self, index: int) -> str:
        subdir = "all" if self.opt.model == "warp" else "warp-cloth"
        return osp.join(self.root, subdir, self.get_input_cloth_name(index))

    def get_input_cloth_name(self, index: int) -> str:
        return self.cloth_names[index]

    def get_person_image_path(self, index: int) -> str:
        return osp.join(self.root, "all", self.get_person_image_name(index))

    def get_person_image_name(self, index: int) -> str:
        return self.image_names[index]

    def get_person_parsed_path(self, index: int) -> str:
        name = self.get_person_image_name(index).replace(".jpg", ".png")
        return osp.join(self.root, "all_parsing", name)

    def get_person_cocopose_path(self, index: int) -> str:
        name = self.get_person_image_name(index).replace(".jpg", "_keypoints.json")
        return osp.join(self.root, "all_person_clothes_keypoints", name)

    def get_person_densepose_path(self, index: int):
        raise NotImplementedError("For now use cocopose on MPV")

    def get_person_flow_path(self, index: int):
        raise NotImplementedError("Image datasets don't have flow")
