"""Turn result frame folders into animated GIFs or MP4s (counterpart of the
repository's convert_folders_to_animated.py; reference
convert_folders_to_animated.py:15-98):

    python -m shineon_tpu_torch.convert_folders_to_animated -i DIR [-o OUT] \
        [--format gif|mp4] [--fps 20]

One file a video folder of ``-i`` (its PNG frames in name order, else its
JPEGs), written to ``-o`` (default ``DIR_animated``): a GIF with PIL, an
MP4 with imageio.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from glob import glob

import numpy as np
from PIL import Image


def argparser(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-i", "--input_dir", required=True,
                        help="directory of per-video frame folders")
    parser.add_argument("-o", "--output_dir", default=None)
    parser.add_argument("--format", choices=("gif", "mp4"), default="gif")
    parser.add_argument("--fps", type=int, default=20)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = argparser(argv)
    out_dir = args.output_dir or args.input_dir + "_animated"
    os.makedirs(out_dir, exist_ok=True)
    for video_folder in sorted(os.listdir(args.input_dir)):
        vdir = osp.join(args.input_dir, video_folder)
        if not osp.isdir(vdir):
            continue
        frame_paths = sorted(glob(osp.join(vdir, "*.png"))) or sorted(
            glob(osp.join(vdir, "*.jpg")))
        if not frame_paths:
            continue
        out_path = osp.join(out_dir, f"{video_folder}.{args.format}")
        if args.format == "gif":
            frames = [Image.open(p).convert("RGB") for p in frame_paths]
            frames[0].save(out_path, save_all=True, append_images=frames[1:],
                           duration=int(1000 / args.fps), loop=0)
        else:
            import imageio

            imageio.mimwrite(out_path, [np.asarray(Image.open(p).convert("RGB"))
                                        for p in frame_paths], fps=args.fps)
        print(f"wrote {out_path} ({len(frame_paths)} frames)")


if __name__ == "__main__":
    main()
