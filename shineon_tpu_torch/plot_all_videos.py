"""Single-experiment SSIM/PSNR sweep over every generated video, to one CSV
(counterpart of the repository's plot_all_videos.py; reference
plot_all_videos.py:57-124):

    python -m shineon_tpu_torch.plot_all_videos -t GT -g DIR \
        [--experiment NAME] [--result OUT]

Writes ``{experiment}_all_videos_metrics.csv`` (file_path, ssim, psnr) and
prints ``frames=N ssim=… psnr=… -> CSV``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from shineon_tpu_torch.calculate_metrics import frame_scores, imread, write_csv


def argparser(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-t", "--ground_truth_dir_path", "--truth", type=str, required=True
    )
    parser.add_argument("-g", "--generated_dir_path", type=str, required=True)
    parser.add_argument("--experiment", type=str, default="1")
    parser.add_argument("--result", type=str, default="metrics_out")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = argparser(argv)
    os.makedirs(args.result, exist_ok=True)
    rows = []
    for video_folder in sorted(os.listdir(args.generated_dir_path)):
        vdir = osp.join(args.generated_dir_path, video_folder)
        if not osp.isdir(vdir):
            continue
        for image_file in sorted(os.listdir(vdir)):
            gt_path = osp.join(args.ground_truth_dir_path, video_folder, image_file)
            if not osp.exists(gt_path):
                continue
            rows.append((osp.join(video_folder, image_file),
                         *frame_scores(imread(gt_path), imread(osp.join(vdir, image_file)))))
    out_csv = osp.join(args.result, f"{args.experiment}_all_videos_metrics.csv")
    write_csv(out_csv, ("file_path", "ssim", "psnr"), rows)
    scores = np.asarray([r[1:] for r in rows], np.float64).reshape(-1, 2)
    # the mean of no frames is nan, as pandas gives it
    ssim_mean, psnr_mean = (scores.mean(axis=0) if len(rows) else (float("nan"),) * 2)
    print(f"frames={len(rows)} ssim={ssim_mean:.4f} psnr={psnr_mean:.2f} -> {out_csv}")


if __name__ == "__main__":
    main()
