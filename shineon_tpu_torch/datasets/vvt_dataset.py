"""The VVT (FW-GAN) video folder layout (counterpart of
shineon_tpu/datasets/vvt_dataset.py; reference datasets/vvt_dataset.py:14-280):
one folder of frames a video, the frames indexed flat with each video's
first index recorded, so that a clip never crosses into the video before."""

from __future__ import annotations

import argparse
import os
import os.path as osp
from glob import glob
from typing import List

import numpy as np

from shineon_tpu_torch.datasets.n_frames_interface import NFramesInterface
from shineon_tpu_torch.datasets.tryon_dataset import TryonDataset
from shineon_tpu_torch.utils.log import get_logger

logger = get_logger()


def extract_frame_substring(path: str) -> str:
    """'**frame_NNN.ext' -> 'frame_NNN' (reference vvt_dataset.py:273-280)."""
    return path[path.find("frame_"):path.rfind(".")]


class VVTDataset(TryonDataset, NFramesInterface):
    @staticmethod
    def modify_commandline_options(parser: argparse.ArgumentParser, is_train: bool,
                                   shared: bool = False):
        """``shared``: the try-on options are already on the parser."""
        if not shared:
            parser = TryonDataset.modify_commandline_options(parser, is_train)
        parser = NFramesInterface.modify_commandline_options(parser, is_train)
        parser.add_argument("--vvt_dataroot", default="/data_hdd/fw_gan_vvt")
        parser.add_argument(
            "--warp_cloth_dir",
            help="Path to the GMM-generated intermediary warp-cloth folder for "
            "TOM. If not specified, looks under --vvt_dataroot.",
        )
        return parser

    @staticmethod
    def extract_video_id(image_path: str) -> str:
        """The folder that holds the frame file."""
        return image_path.split(os.sep)[-2]

    def __init__(self, opt, i_am_validation: bool = False):
        self.root = opt.vvt_dataroot
        self._video_start_indices = set()
        TryonDataset.__init__(self, opt, i_am_validation)
        NFramesInterface.__init__(self, opt)

    # ---------- paths (vvt_dataset.py:56-115) ----------

    def _tryon_task_active(self) -> bool:
        """The try-on task (a new garment on each person): a test run with
        ``tryon_list`` or ``random_tryon``."""
        return not self.opt.is_train and bool(self.opt.tryon_list or self.opt.random_tryon)

    def load_file_paths(self, i_am_validation: bool = False):
        if self._tryon_task_active():
            self.load_file_paths_for_tryon_task()
        else:
            self.load_file_paths_for_reconstruction_task(i_am_validation)

    def load_file_paths_for_reconstruction_task(self, i_am_validation: bool):
        folder = f"{self.opt.datamode}/{self.opt.datamode}_frames"
        video_folders = sorted(glob(f"{self.root}/{folder}/*/"))
        num_videos = len(video_folders)
        validation_index = int((1 - self.val_fraction) * num_videos)
        start, end = (validation_index, num_videos) if i_am_validation else (0, validation_index)
        self.register_videos(video_folders, start, end)

    def register_videos(self, video_folders: List[str], start: int = 0, end: int = -1):
        for video_folder in video_folders[start:end]:
            self._video_start_indices.add(len(self.image_names))
            self.image_names.extend(sorted(glob(f"{video_folder}/*.png")))

    def load_file_paths_for_tryon_task(self):
        """Cloth-video pairs from ``tryon_list``'s CSV, or the fixed random
        pairing of ``random_tryon``."""
        self.video_ids_to_cloth_paths = {}
        video_folders = []
        for cloth_path, video_id in self._tryon_pairs():
            self.video_ids_to_cloth_paths[video_id] = cloth_path
            video_folders.append(osp.join(self.opt.vvt_dataroot, self.opt.datamode,
                                          f"{self.opt.datamode}_frames", video_id))
        self.register_videos(video_folders, 0, len(video_folders))

    def _tryon_pairs(self):
        """(cloth_path, video_id) pairs: the CSV's rows verbatim, or with
        ``random_tryon`` each test video with the product cloth of another
        video, by a ``RandomState(420)`` permutation (reference
        vvt_dataset.py:133)."""
        if self.opt.tryon_list:
            with open(self.opt.tryon_list, "r") as f:
                return [tuple(part.strip() for part in line.split(","))
                        for line in f.readlines() if line.strip()]
        folder = f"{self.opt.datamode}/{self.opt.datamode}_frames"
        video_ids = [osp.basename(osp.normpath(p))
                     for p in sorted(glob(f"{self.root}/{folder}/*/"))]
        assert video_ids, f"random_tryon found no videos under {folder}"
        cloth_root = osp.join(self.root, "clothes_person", "img")
        cloths = [self.find_cloth_path_under_vvt_root("cloth_front", cloth_root, vid)
                  for vid in video_ids]
        order = np.random.RandomState(420).permutation(len(video_ids))
        return [(cloths[order[(k + 1) % len(order)]], video_ids[order[k]])
                for k in range(len(order))]

    # ---------- cloth paths (vvt_dataset.py:122-186) ----------

    def get_input_cloth_path(self, index: int) -> str:
        image_path = self.image_names[index]
        video_id = VVTDataset.extract_video_id(image_path)
        frame_word = extract_frame_substring(image_path)
        if self._tryon_task_active():
            if self.opt.model == "warp":
                return self.video_ids_to_cloth_paths[video_id]
            assert self.opt.warp_cloth_dir, (
                "try-on task TOM/SAMS runs need warp_cloth_dir pointed at the stage-1 warp export")
            cloth_folder = osp.join(self.opt.warp_cloth_dir, video_id)
            matches = sorted(glob(f"{cloth_folder}/*{frame_word}*"))
            assert matches, (
                f"no stage-1 warp-cloth file for {frame_word!r} under {cloth_folder}; run the "
                f"warp model with the same try-on pairing first")
            return matches[0]
        if self.opt.model == "warp":
            path = osp.join(self.root, "clothes_person", "img")
            keyword = "cloth_front"
        else:
            path = (osp.join(self.root, self.opt.datamode, "warp-cloth")
                    if self.opt.warp_cloth_dir is None else self.opt.warp_cloth_dir)
            keyword = f"cloth_front*{frame_word}"
        return self.find_cloth_path_under_vvt_root(keyword, path, video_id)

    def find_cloth_path_under_vvt_root(self, keyword, path, video_id) -> str:
        # VVT's clothes_person folders are upper-case with a trailing garment
        # id (the reference's layout hack, vvt_dataset.py:150-153)
        video_id, cloth_id = video_id.upper().split("-")
        cloth_folder = osp.join(path, video_id)
        search = f"{cloth_folder}/{video_id}-{cloth_id}*{keyword}.*"
        matches = sorted(glob(search))
        if not matches:
            logger.debug(f"{search=} not found, relaxing search to any cloth term.")
            matches = sorted(glob(f"{cloth_folder}/{video_id}-{cloth_id}*cloth*"))
        assert matches, (
            f"no cloth file matches {search!r}; if this is a TOM/SAMS run, point "
            f"warp_cloth_dir at the exported warp outputs")
        return matches[0]

    def get_input_cloth_name(self, index: int) -> str:
        cloth_path = self.get_input_cloth_path(index)
        if self._tryon_task_active():
            video_id = VVTDataset.extract_video_id(self.image_names[index])
        else:
            video_id = VVTDataset.extract_video_id(cloth_path)
        frame_name = osp.basename(self.get_person_image_name(index))
        return osp.join(video_id, f"{osp.basename(cloth_path)}.FOR.{frame_name}")

    # ---------- person and annotation paths (vvt_dataset.py:190-241) ----------

    def get_person_image_path(self, index: int) -> str:
        return self.image_names[index]

    def get_person_image_name(self, index: int) -> str:
        image_path = self.get_person_image_path(index)
        return osp.join(VVTDataset.extract_video_id(image_path), osp.basename(image_path))

    def _annotation_path(self, index: int, folder: str, suffix: str) -> str:
        image_path = self.get_person_image_path(index)
        fname = os.path.split(image_path)[-1].replace(".png", suffix)
        return osp.join(self.root, self.opt.datamode, folder,
                        VVTDataset.extract_video_id(image_path), fname)

    def get_person_parsed_path(self, index: int) -> str:
        parsed_path = self._annotation_path(index, f"{self.opt.datamode}_frames_parsing",
                                            "_label.png")
        if not os.path.exists(parsed_path):
            parsed_path = parsed_path.replace("_label", "")
        return parsed_path

    def get_person_cocopose_path(self, index: int) -> str:
        return self._annotation_path(index, f"{self.opt.datamode}_frames_keypoint",
                                     "_keypoints.json")

    def get_person_densepose_path(self, index: int) -> str:
        return self._annotation_path(index, "densepose", "_IUV.png")

    def get_person_flow_path(self, index: int) -> str:
        image_path = self.get_person_image_path(index).replace(".png", ".flo")
        return image_path.replace(f"{self.opt.datamode}_frames", "optical_flow")

    # ---------- clips (vvt_dataset.py:244-259) ----------

    def collect_n_frames_indices(self, index: int) -> List[int]:
        """Walk back n frames, repeating a video's first index at its start."""
        indices: List[int] = []
        for i in range(index, index - self.n_frames_total, -1):
            assert i > -1, f"frame walk-back reached a negative index ({i})"
            if i in self._video_start_indices or i == 0:
                indices = [i] * (self.n_frames_total - len(indices)) + indices
                break
            indices.insert(0, i)
        return indices

    @NFramesInterface.return_n_frames
    def __getitem__(self, index: int):
        return super().__getitem__(index)
