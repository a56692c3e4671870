"""A test-only list pairing GFLA frame folders with clothes (counterpart of
shineon_tpu/datasets/vvt_list_dataset.py; reference
datasets/vvt_list_dataset.py:8-65). ``stage`` ("GMM", the parser's
default, or "TOM") picks the cloth source."""

from __future__ import annotations

import os.path as osp
from glob import glob

from shineon_tpu_torch.datasets.vvt_dataset import VVTDataset


class VVTListDataset(VVTDataset):
    @staticmethod
    def modify_commandline_options(parser, is_train, shared: bool = False):
        parser = VVTDataset.modify_commandline_options(parser, is_train, shared)
        parser.add_argument(
            "--data_list",
            help="3-column list pairing GFLA frame folders with cloth ids",
        )
        parser.add_argument(
            "--stage", choices=("GMM", "TOM"), default="GMM",
            help="which stage's cloth sources to pair (vvt_list_dataset.py:27-40)",
        )
        return parser

    def __init__(self, opt, i_am_validation: bool = False):
        self.data_list = opt.data_list
        self.image_paths = []
        self.cloth_paths = []
        super().__init__(opt, i_am_validation)

    def load_file_paths(self, i_am_validation: bool = False):
        self.root = self.opt.vvt_dataroot
        stage = getattr(self.opt, "stage", "GMM")
        with open(self.data_list, "r") as f:
            for line in f:
                image_dir, cloth_id, _ = line.strip().split()
                image_paths = sorted(glob(f"{self.root}/lip_test_frames/{image_dir}/*.png"))
                if stage == "GMM":
                    cloth_file = glob(f"{self.root}/lip_clothes_person/{cloth_id}/*cloth*")[0]
                    cloth_paths = [cloth_file] * len(image_paths)
                elif stage == "TOM":
                    cloth_paths = sorted(glob(f"{self.root}/warp-cloth/{image_dir}/*.png"))
                else:
                    raise ValueError(f"unknown stage {stage}")
                assert len(image_paths) == len(cloth_paths), (
                    f"frame/warp counts differ for {image_dir}")
                self.image_paths.extend(image_paths)
                self.cloth_paths.extend(cloth_paths)
        self.image_names = self.image_paths

    def __len__(self):
        return len(self.image_paths)

    def get_person_image_path(self, index: int) -> str:
        return self.image_paths[index]

    def get_input_cloth_path(self, index: int) -> str:
        return self.cloth_paths[index]

    def get_input_cloth_name(self, index: int) -> str:
        folder_id = VVTDataset.extract_video_id(self.get_person_image_path(index))
        base_cloth_name = osp.basename(self.get_input_cloth_path(index))
        frame_name = osp.basename(self.get_person_image_name(index))
        return osp.join(folder_id, f"{base_cloth_name}.FOR.{frame_name}")
