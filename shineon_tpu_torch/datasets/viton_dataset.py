"""The VITON folder layout (counterpart of
shineon_tpu/datasets/viton_dataset.py; reference datasets/viton_dataset.py:7-96):
``{viton_dataroot}/{data_list}`` pairs ``person.jpg cloth.jpg`` per line;
the images under ``{viton_dataroot}/{datamode}/``."""

from __future__ import annotations

import argparse
import os.path as osp

from shineon_tpu_torch.datasets.tryon_dataset import TryonDataset


class VitonDataset(TryonDataset):
    @staticmethod
    def modify_commandline_options(parser: argparse.ArgumentParser, is_train: bool,
                                   shared: bool = False):
        """``shared``: the try-on options are already on the parser."""
        if not shared:
            parser = TryonDataset.modify_commandline_options(parser, is_train)
        parser.add_argument("--viton_dataroot", default="data")
        parser.add_argument("--data_list", default="train_pairs.txt")
        return parser

    def __init__(self, opt, i_am_validation: bool = False):
        # VITON has no validation split (reference viton_dataset.py:21)
        super().__init__(opt)
        self.data_list = opt.data_list
        self.data_path = osp.join(opt.viton_dataroot, opt.datamode)

    def load_file_paths(self, i_am_validation: bool = False):
        self.root = self.opt.viton_dataroot
        self.data_path = osp.join(self.opt.viton_dataroot, self.opt.datamode)
        im_names, c_names = [], []
        with open(osp.join(self.root, self.opt.data_list), "r") as f:
            for line in f.readlines():
                im_name, c_name = line.strip().split()
                im_names.append(im_name)
                c_names.append(c_name)
        self.image_names = im_names
        self.cloth_names = c_names

    def get_input_cloth_path(self, index: int) -> str:
        # the warp stage reads the product cloth, TOM the GMM-warped one
        folder = "cloth" if self.opt.model == "warp" else "warp-cloth"
        return osp.join(self.data_path, folder, self.get_input_cloth_name(index))

    def get_input_cloth_name(self, index: int) -> str:
        return self.cloth_names[index]

    def get_person_image_name(self, index: int) -> str:
        return self.image_names[index]

    def get_person_image_path(self, index: int) -> str:
        return osp.join(self.data_path, "image", self.get_person_image_name(index))

    def get_person_parsed_path(self, index: int) -> str:
        parse_name = self.get_person_image_name(index).replace(".jpg", ".png")
        return osp.join(self.data_path, "image-parse", parse_name)

    def get_person_cocopose_path(self, index: int) -> str:
        pose_name = self.get_person_image_name(index).replace(".jpg", "_keypoints.json")
        return osp.join(self.data_path, "pose", pose_name)

    def get_person_flow_path(self, index: int):
        raise NotImplementedError("Image datasets don't have flow")

    def get_person_densepose_path(self, index: int):
        raise NotImplementedError("For now use cocopose on VITON")
