"""Resize raw VITON data to the training size (counterpart of the
repository's tools/convert_viton_raw.py; the reference's MATLAB converter
convert_data.m:1-30):

    python -m shineon_tpu_torch.tools.convert_viton_raw --src viton_raw/train \
        --dst data/train [--height 256 --width 192]

``cloth`` and ``image`` are resized bilinearly, ``cloth-mask`` and
``image-parse`` with nearest neighbours (label maps must not interpolate),
all with PIL; the ``pose`` keypoints are rescaled by the ratio of the new
size to the first source image's.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from glob import glob

import numpy as np
from PIL import Image


def resize_folder(src: str, dst: str, size, resample, suffix="*") -> int:
    os.makedirs(dst, exist_ok=True)
    n = 0
    for path in sorted(glob(osp.join(src, suffix))):
        Image.open(path).resize(size, resample).save(osp.join(dst, osp.basename(path)))
        n += 1
    return n


def rescale_pose_folder(src: str, dst: str, sx: float, sy: float) -> int:
    os.makedirs(dst, exist_ok=True)
    n = 0
    for path in sorted(glob(osp.join(src, "*.json"))):
        with open(path) as f:
            label = json.load(f)
        for person in label.get("people", []):
            kp = np.array(person.get("pose_keypoints", []), np.float64).reshape(-1, 3)
            kp[:, 0] *= sx
            kp[:, 1] *= sy
            person["pose_keypoints"] = kp.reshape(-1).tolist()
        with open(osp.join(dst, osp.basename(path)), "w") as f:
            json.dump(label, f)
        n += 1
    return n


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", required=True, help="raw VITON split folder")
    parser.add_argument("--dst", required=True)
    parser.add_argument("--height", type=int, default=256)
    parser.add_argument("--width", type=int, default=192)
    args = parser.parse_args(argv)
    size = (args.width, args.height)

    sample = sorted(glob(osp.join(args.src, "image", "*")))
    sx = sy = 1.0
    if sample:
        with Image.open(sample[0]) as im:
            sx, sy = args.width / im.width, args.height / im.height
    for folder, resample in (("cloth", Image.BILINEAR), ("cloth-mask", Image.NEAREST),
                             ("image", Image.BILINEAR), ("image-parse", Image.NEAREST)):
        src = osp.join(args.src, folder)
        if osp.isdir(src):
            n = resize_folder(src, osp.join(args.dst, folder), size, resample)
            print(f"{folder}: {n} files -> {size}")
    pose_src = osp.join(args.src, "pose")
    if osp.isdir(pose_src):
        n = rescale_pose_folder(pose_src, osp.join(args.dst, "pose"), sx, sy)
        print(f"pose: {n} keypoint files rescaled (x{sx:.3f}, x{sy:.3f})")


if __name__ == "__main__":
    main()
