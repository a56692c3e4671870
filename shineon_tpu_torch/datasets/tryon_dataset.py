"""TryonDataset: the per-sample raw arrays of the try-on models
(counterpart of shineon_tpu/datasets/tryon_dataset.py; reference
datasets/tryon_dataset.py:44-537).

On the host, this class resolves the file paths (abstract getters, one set
per dataset layout), decodes them with PIL, center-crops them and returns a
flat dict of fixed-shape uint8 and float arrays; the device makes the
normalized features from them (:mod:`.preprocess`). An image is
``convert("RGB")``; a label map keeps its palette indices (the first
channel of a map that has several); ``.flo`` flows are read with
:func:`.flow_utils.read_flow`.

Absent annotations are data, as in the reference (tryon_dataset.py:262-266,
290-296, 309-313): a previous frame, densepose map or flow file that does
not exist, and keypoints that do not exist or list no person, give zeros
and a validity flag of 0, which the device features consume. A person
image, cloth or label map that does not exist raises, and so does every
file that exists but does not decode.
"""

from __future__ import annotations

import json
import os.path as osp
from abc import ABC, abstractmethod
from argparse import ArgumentParser
from typing import Dict

import numpy as np
from PIL import Image

from shineon_tpu_torch.datasets import channels
from shineon_tpu_torch.datasets.base_dataset import BaseDataset
from shineon_tpu_torch.datasets.flow_utils import flow_to_image, read_flow

# the checkerboard that visualizes the GMM's TPS warp (reference
# tryon_dataset.py:483-487 opens the repository's grid.png)
GRID_VIS_PATH = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
                         "grid.png")


class TryonDataset(BaseDataset, ABC):
    """Loads raw per-sample arrays for the try-on models."""

    @staticmethod
    def modify_commandline_options(parser: ArgumentParser, is_train: bool):
        """The try-on datasets' options (tryon_dataset.py:61-87 of the JAX
        package); at test time the whole set, no validation split."""
        parser.add_argument(
            "--val_fraction", type=float, default=0.01,
            help="portion of the training data split off for validation",
        )
        if not is_train:
            parser.set_defaults(val_fraction=0)
        parser.add_argument(
            "--cloth_mask_threshold", type=int, default=240,
            help="white-background cutoff for deriving the cloth mask: pixels "
            "brighter than this (0-255) are masked out.",
        )
        parser.add_argument("--image_scale", type=float, default=1, help="first scale to this")
        parser.add_argument("--fine_width", type=int, default=192, help="then crop to this")
        parser.add_argument("--fine_height", type=int, default=256, help="then crop to this")
        parser.add_argument("--radius", type=int, default=5)
        parser.add_argument(
            "--visualize_flow", action="store_true",
            help="Visualize flow for debugging (heavy).",
        )
        return parser

    def __init__(self, opt, i_am_validation: bool = False):
        super().__init__(opt)
        self.val_fraction = opt.val_fraction
        self.cloth_mask_threshold = opt.cloth_mask_threshold
        self.datamode = opt.datamode
        self.fine_height = opt.fine_height
        self.fine_width = opt.fine_width
        self.radius = opt.radius
        self.image_names = []
        self.i_am_validation = i_am_validation
        self.load_file_paths(i_am_validation)

    @abstractmethod
    def load_file_paths(self, i_am_validation: bool = False):
        """Set self.image_names (and the cloth names) for the layout."""

    @classmethod
    def make_validation_dataset(cls, opt) -> "TryonDataset":
        return cls(opt, i_am_validation=True)

    def __len__(self) -> int:
        return len(self.image_names)

    # ---------- host decode ----------

    def center_crop(self, array: np.ndarray) -> np.ndarray:
        """Crop from the centre to (fine_height, fine_width), zero-padding a
        smaller image (torchvision's CenterCrop)."""
        th, tw = self.fine_height, self.fine_width
        h, w = array.shape[:2]
        out = np.zeros((th, tw) + array.shape[2:], array.dtype)
        y0, x0 = (h - th) // 2, (w - tw) // 2
        src_y0, dst_y0 = max(y0, 0), max(-y0, 0)
        src_x0, dst_x0 = max(x0, 0), max(-x0, 0)
        copy_h = min(th - dst_y0, h - src_y0)
        copy_w = min(tw - dst_x0, w - src_x0)
        out[dst_y0:dst_y0 + copy_h, dst_x0:dst_x0 + copy_w] = array[
            src_y0:src_y0 + copy_h, src_x0:src_x0 + copy_w]
        return out

    def open_image_u8(self, path: str) -> np.ndarray:
        """An RGB image, center-cropped: (H, W, 3) uint8."""
        with Image.open(path) as img:
            return self.center_crop(np.asarray(img.convert("RGB"), np.uint8))

    def open_label_u8(self, path: str) -> np.ndarray:
        """A label map (palette indices or grey levels), center-cropped:
        (H, W) uint8."""
        with Image.open(path) as img:
            arr = np.asarray(img, np.uint8)
        if arr.ndim == 3:
            arr = arr[..., 0]
        return self.center_crop(arr)

    # ---------- cloth (tryon_dataset.py:158-196) ----------

    def get_cloth_raw(self, index: int) -> Dict[str, np.ndarray]:
        return {"cloth_u8": self.open_image_u8(self.get_input_cloth_path(index))}

    @abstractmethod
    def get_input_cloth_path(self, index: int) -> str:
        """The cloth image's path."""

    @abstractmethod
    def get_input_cloth_name(self, index: int) -> str:
        """The name an export writes the sample under."""

    # ---------- person (tryon_dataset.py:203-367) ----------

    def get_person_raw(self, index: int) -> Dict[str, np.ndarray]:
        ret: Dict[str, np.ndarray] = {}
        ret["image_u8"] = self.open_image_u8(self.get_person_image_path(index))
        try:
            ret["prev_image_u8"] = self.open_image_u8(self.get_person_image_path(index - 1))
            ret["prev_image_valid"] = np.float32(1.0)
        except FileNotFoundError:
            ret["prev_image_u8"] = np.zeros_like(ret["image_u8"])
            ret["prev_image_valid"] = np.float32(0.0)
        ret["parse_u8"] = self.open_label_u8(self.get_person_parsed_path(index))
        if "cocopose" in self.opt.person_inputs:
            ret["cocopose_kp"] = self.get_cocopose_keypoints(index)
        if "densepose" in self.opt.person_inputs:
            try:
                ret["densepose_u8"] = self.open_image_u8(self.get_person_densepose_path(index))
                ret["densepose_valid"] = np.float32(1.0)
            except FileNotFoundError:
                ret["densepose_u8"] = np.zeros((self.fine_height, self.fine_width, 3), np.uint8)
                ret["densepose_valid"] = np.float32(0.0)
        return ret

    def get_cocopose_keypoints(self, index: int) -> np.ndarray:
        """COCO keypoint JSON -> (18, 3) float32; zeros (all invalid) when
        the file does not exist or lists no person (tryon_dataset.py:369-395)."""
        out = np.zeros((channels.COCOPOSE_CHANNELS, 3), np.float32)
        try:
            with open(self.get_person_cocopose_path(index), "r") as f:
                people = json.load(f)["people"]
            pose_data = np.array(people[0]["pose_keypoints"], np.float32).reshape(-1, 3)
        except (FileNotFoundError, IndexError):
            return out
        n = min(len(pose_data), channels.COCOPOSE_CHANNELS)
        out[:n] = pose_data[:n]
        return out

    def get_flow_raw(self, index: int) -> Dict[str, np.ndarray]:
        """The .flo flow, center-cropped, and with ``visualize_flow`` its
        colour image; zeros and a flag of 0 when the layout has no flow or
        the file does not exist (tryon_dataset.py:272-298)."""
        ret: Dict[str, np.ndarray] = {}
        visualize = self.opt.visualize_flow
        try:
            flow = read_flow(self.get_person_flow_path(index))
        except (NotImplementedError, FileNotFoundError):
            ret["flow_raw"] = np.zeros((self.fine_height, self.fine_width, 2), np.float32)
            ret["flow_valid"] = np.float32(0.0)
            if visualize:
                ret["flow_image_u8"] = np.zeros((self.fine_height, self.fine_width, 3), np.uint8)
            return ret
        ret["flow_raw"] = self.center_crop(flow)
        ret["flow_valid"] = np.float32(1.0)
        if visualize:
            ret["flow_image_u8"] = self.center_crop(flow_to_image(flow))
        return ret

    @abstractmethod
    def get_person_image_path(self, index: int) -> str: ...

    @abstractmethod
    def get_person_image_name(self, index: int) -> str: ...

    @abstractmethod
    def get_person_cocopose_path(self, index: int) -> str: ...

    @abstractmethod
    def get_person_parsed_path(self, index: int) -> str: ...

    @abstractmethod
    def get_person_densepose_path(self, index: int) -> str: ...

    @abstractmethod
    def get_person_flow_path(self, index: int) -> str: ...

    # ---------- getitem (tryon_dataset.py:481-537) ----------

    def __getitem__(self, index: int) -> Dict:
        result: Dict = {
            "dataset_name": self.__class__.__name__,
            "cloth_name": self.get_input_cloth_name(index),
            "cloth_path": self.get_input_cloth_path(index),
            "image_name": self.get_person_image_name(index),
            "image_path": self.get_person_image_path(index),
        }
        if self.opt.model == "warp":
            result["grid_vis_u8"] = self.open_image_u8(GRID_VIS_PATH)
        if getattr(self.opt, "flow_warp", False) or "flow" in self.opt.person_inputs:
            result.update(self.get_flow_raw(index))
        result.update(self.get_cloth_raw(index))
        result.update(self.get_person_raw(index))
        return result
