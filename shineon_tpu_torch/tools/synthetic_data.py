"""Synthetic VITON, VVT and MPV trees, drawn from a numpy seed (the layouts
of the repository's test fixtures, tests/fixtures.py, written with the
port's ``write_flow`` and PIL at any height and width): procedural person
images, label maps, keypoints, densepose maps, ``.flo`` flows, product
cloths and GMM-warped cloths. For the same seed, size and counts the files
are those of the fixtures, byte for byte."""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
from PIL import Image

from shineon_tpu_torch.datasets.flow_utils import write_flow

H, W = 256, 192  # the canvas the boxes below are given on


def _box(h, w, y0, y1, x0, x1):
    """A box of the 256x192 canvas, scaled to (h, w)."""
    return slice(y0 * h // H, y1 * h // H), slice(x0 * w // W, x1 * w // W)


def _person_image(rng, torso_color=None, h=H, w=W) -> np.ndarray:
    img = np.full((h, w, 3), 230, np.uint8)
    img[_box(h, w, 40, 220, 60, 130)] = rng.randint(40, 200, 3) if torso_color is None \
        else torso_color
    img[_box(h, w, 20, 48, 80, 110)] = (200, 170, 150)  # head
    return img


def _parse_map(h=H, w=W) -> np.ndarray:
    parse = np.zeros((h, w), np.uint8)
    parse[_box(h, w, 40, 220, 60, 130)] = 5  # upper clothes
    parse[_box(h, w, 20, 48, 80, 110)] = 13  # face
    parse[_box(h, w, 48, 60, 85, 105)] = 2  # hair
    parse[_box(h, w, 180, 220, 60, 130)] = 9  # pants
    return parse


def _cloth_image(rng, color=None, h=H, w=W) -> np.ndarray:
    img = np.full((h, w, 3), 255, np.uint8)  # white background
    img[_box(h, w, 60, 200, 50, 140)] = rng.randint(30, 220, 3) if color is None else color
    return img


def _keypoints(rng, h=H, w=W) -> dict:
    kp = []
    margin_x, margin_y = max(w // 20, 2), max(h // 26, 2)
    for _ in range(18):
        kp.extend([float(rng.randint(margin_x, w - margin_x)),
                   float(rng.randint(margin_y, h - margin_y)), 1.0])
    return {"people": [{"pose_keypoints": kp}]}


def _save(array: np.ndarray, path: str) -> None:
    Image.fromarray(array).save(path)


def _write_json(payload: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(payload, f)


def make_viton_tree(root: str, n: int = 4, datamode: str = "train", seed: int = 0,
                    height: int = H, width: int = W) -> str:
    """{root}/{datamode}/{cloth,warp-cloth,image,image-parse,pose} and
    {root}/{datamode}_pairs.txt ("person.jpg cloth.jpg" a line); returns the
    list's name."""
    rng = np.random.RandomState(seed)
    base = osp.join(root, datamode)
    for sub in ("cloth", "warp-cloth", "image", "image-parse", "pose"):
        os.makedirs(osp.join(base, sub), exist_ok=True)
    pairs = []
    for i in range(n):
        im_name, c_name = f"person_{i}.jpg", f"cloth_{i}.jpg"
        _save(_person_image(rng, h=height, w=width), osp.join(base, "image", im_name))
        cloth = _cloth_image(rng, h=height, w=width)
        _save(cloth, osp.join(base, "cloth", c_name))
        _save(cloth, osp.join(base, "warp-cloth", c_name))
        _save(_parse_map(height, width), osp.join(base, "image-parse",
                                                  im_name.replace(".jpg", ".png")))
        _write_json(_keypoints(rng, height, width),
                    osp.join(base, "pose", im_name.replace(".jpg", "_keypoints.json")))
        pairs.append(f"{im_name} {c_name}")
    list_name = f"{datamode}_pairs.txt"
    with open(osp.join(root, list_name), "w") as f:
        f.write("\n".join(pairs) + "\n")
    return list_name


def make_vvt_tree(root: str, n_videos: int = 2, frames: int = 6, datamode: str = "train",
                  seed: int = 0, with_flow: bool = True, with_densepose: bool = True,
                  height: int = H, width: int = W) -> None:
    """The VVT layout: a frame folder a video with its parsing, keypoint,
    densepose and optical-flow folders, the product cloth under
    clothes_person/img, and a GMM-warped cloth a frame under warp-cloth.
    Each video's person wears its product cloth's colour in every frame."""
    rng = np.random.RandomState(seed)
    h, w = height, width
    for v in range(n_videos):
        vid = f"vid{v}-g0{v}"
        up_vid, up_g = vid.upper().split("-")
        dirs = {sub: osp.join(root, datamode, sub, vid) for sub in (
            f"{datamode}_frames", f"{datamode}_frames_parsing", f"{datamode}_frames_keypoint",
            "densepose", "optical_flow")}
        cdir = osp.join(root, "clothes_person", "img", up_vid)
        wdir = osp.join(root, datamode, "warp-cloth", up_vid)
        for d in (*dirs.values(), cdir, wdir):
            os.makedirs(d, exist_ok=True)
        cloth_color = rng.randint(30, 220, 3)
        _save(_cloth_image(rng, cloth_color, h, w),
              osp.join(cdir, f"{up_vid}-{up_g}=cloth_front.jpg"))
        for t in range(frames):
            _save(_cloth_image(rng, cloth_color, h, w),
                  osp.join(wdir, f"{up_vid}-{up_g}=cloth_front_frame_{t:03d}.png"))
        for t in range(frames):
            name = f"frame_{t:03d}"
            _save(_person_image(rng, cloth_color, h, w),
                  osp.join(dirs[f"{datamode}_frames"], f"{name}.png"))
            _save(_parse_map(h, w), osp.join(dirs[f"{datamode}_frames_parsing"],
                                             f"{name}_label.png"))
            _write_json(_keypoints(rng, h, w),
                        osp.join(dirs[f"{datamode}_frames_keypoint"], f"{name}_keypoints.json"))
            if with_densepose:
                _save(rng.randint(0, 255, (h, w, 3)).astype(np.uint8),
                      osp.join(dirs["densepose"], f"{name}_IUV.png"))
            if with_flow:
                write_flow(osp.join(dirs["optical_flow"], f"{name}.flo"),
                           rng.randn(h, w, 2).astype(np.float32))


def make_mpv_tree(root: str, n: int = 2, seed: int = 0, height: int = H, width: int = W) -> None:
    """The MPV layout: all/, warp-cloth/, all_parsing/,
    all_person_clothes_keypoints/ and all_poseA_poseB_clothes_0607.txt."""
    rng = np.random.RandomState(seed)
    for sub in ("all", "warp-cloth", "all_parsing", "all_person_clothes_keypoints"):
        os.makedirs(osp.join(root, sub), exist_ok=True)
    lines = []
    for i in range(n):
        p1, p2, cloth = f"pA_{i}.jpg", f"pB_{i}.jpg", f"c_{i}.jpg"
        for p in (p1, p2):
            _save(_person_image(rng, h=height, w=width), osp.join(root, "all", p))
            _save(_parse_map(height, width),
                  osp.join(root, "all_parsing", p.replace(".jpg", ".png")))
            _write_json(_keypoints(rng, height, width),
                        osp.join(root, "all_person_clothes_keypoints",
                                 p.replace(".jpg", "_keypoints.json")))
        c_img = _cloth_image(rng, h=height, w=width)
        _save(c_img, osp.join(root, "all", cloth))
        _save(c_img, osp.join(root, "warp-cloth", cloth))
        lines.append(f"{p1} {p2} {cloth} 0")
    with open(osp.join(root, "all_poseA_poseB_clothes_0607.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")

