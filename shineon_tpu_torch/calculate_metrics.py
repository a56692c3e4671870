"""Offline SSIM/PSNR of two experiments' generated video folders against
the ground truth (counterpart of the repository's calculate_metrics.py;
reference calculate_metrics.py:14-144):

    python -m shineon_tpu_torch.calculate_metrics -t GT -g1 DIR1 [-g2 DIR2] \
        [--experiment_one NAME] [--experiment_two NAME] [--result OUT] [--no_video]

For each video folder of ``-g1`` and each frame present in the ground
truth and both experiments: SSIM and PSNR of each experiment against the
ground truth, with ``data_range = generated.max() - generated.min()``
(shineon_tpu_torch.utils.metrics). Writes a CSV a video
(``{one}_{two}_{video}_metrics_output.csv``), the SSIM/PSNR plot a video
when matplotlib is there, a side-by-side MP4 a video unless ``--no_video``
(imageio), and prints the summary line ``frames=N ssim_1=… ssim_2=…
psnr_1=… psnr_2=…``. The CSVs are written with the csv module in pandas'
``to_csv`` format (shortest round-trip floats), so no pandas is needed.
"""

from __future__ import annotations

import argparse
import csv
import os
import os.path as osp

import numpy as np
from PIL import Image

from shineon_tpu_torch.utils.metrics import peak_signal_noise_ratio as psnr
from shineon_tpu_torch.utils.metrics import structural_similarity as ssim

COLUMNS = ("file_path", "ssim_truth_generated_1", "ssim_truth_generated_2",
           "psnr_truth_generated_1", "psnr_truth_generated_2")


def argparser(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "-t", "--ground_truth_dir_path", "--truth", type=str,
        default="data/fw_gan_vvt/train/train_frames",
    )
    parser.add_argument("-g1", "--generated_dir_path_1", type=str, required=True)
    parser.add_argument("-g2", "--generated_dir_path_2", type=str, default=None)
    parser.add_argument("--experiment_one", type=str, default="1")
    parser.add_argument("--experiment_two", type=str, default="2")
    parser.add_argument("--result", type=str, default="metrics_out")
    parser.add_argument("--no_video", action="store_true",
                        help="skip writing comparison MP4s")
    return parser.parse_args(argv)


def imread(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def frame_scores(gt: np.ndarray, generated: np.ndarray):
    """(SSIM, PSNR) of a generated frame against the ground truth, over the
    generated frame's own range."""
    data_range = float(generated.max()) - float(generated.min())
    return (ssim(gt, generated, data_range=data_range, multichannel=True),
            psnr(gt, generated, data_range=data_range))


def write_csv(path: str, columns, rows) -> None:
    """``rows`` under a header of ``columns``, as pandas' ``to_csv(index=False)``
    writes them: floats as Python's shortest round-trip repr."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(columns)
        writer.writerows([[repr(float(v)) if isinstance(v, float) else v for v in row]
                          for row in rows])


def write_video(path: str, frames: list, fps: int = 20) -> None:
    try:
        import imageio

        imageio.mimwrite(path, frames, fps=fps)
    except Exception as exc:  # no imageio or no MP4 writer
        print(f"skipping video write ({exc})")


def plot(args, columns: dict, video_folder: str) -> None:
    """The SSIM and PSNR curves of one video, when matplotlib is there."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    _, axs = plt.subplots(2)
    plt.suptitle(f"{video_folder} Plot")
    idx = range(len(columns[COLUMNS[1]]))
    for ax, name, color in ((0, COLUMNS[1], "b"), (0, COLUMNS[2], "g"), (1, COLUMNS[3], "r"),
                            (1, COLUMNS[4], "y")):
        axs[ax].plot(idx, columns[name], label=name, color=color)
    axs[0].legend()
    axs[1].legend()
    plt.xlabel("# of Frames")
    plt.savefig(osp.join(
        args.result, f"{args.experiment_one}_{args.experiment_two}_{video_folder}_plot.png"))
    plt.close()


def main(argv=None) -> None:
    args = argparser(argv)
    os.makedirs(args.result, exist_ok=True)
    gen2 = args.generated_dir_path_2 or args.generated_dir_path_1

    all_rows = []
    video_folders = sorted(os.listdir(args.generated_dir_path_1))
    if not video_folders:
        raise SystemExit(f"no videos under {args.generated_dir_path_1}")
    for video_folder in video_folders:
        frames_for_video = []
        rows = []
        for image_file in sorted(os.listdir(osp.join(args.generated_dir_path_1, video_folder))):
            paths = [osp.join(root, video_folder, image_file) for root in (
                args.ground_truth_dir_path, args.generated_dir_path_1, gen2)]
            if not all(osp.exists(p) for p in paths):
                continue
            gt, g1, g2 = (imread(p) for p in paths)
            (s1, p1), (s2, p2) = frame_scores(gt, g1), frame_scores(gt, g2)
            rows.append((osp.join(video_folder, image_file), s1, s2, p1, p2))
            if not args.no_video:
                frames_for_video.append(np.concatenate([gt, g1, g2], axis=1).astype(np.uint8))
        if not rows:
            continue
        all_rows.extend(rows)
        write_csv(osp.join(args.result, f"{args.experiment_one}_{args.experiment_two}_"
                                         f"{video_folder}_metrics_output.csv"), COLUMNS, rows)
        if frames_for_video and not args.no_video:
            write_video(osp.join(args.result, f"compare_{args.experiment_one}_"
                                              f"{args.experiment_two}_{video_folder}.mp4"),
                        frames_for_video)
        plot(args, {name: [r[i] for r in rows] for i, name in enumerate(COLUMNS)}, video_folder)

    if all_rows:
        arr = np.asarray([r[1:] for r in all_rows], np.float64)
        print(
            f"frames={len(all_rows)} "
            f"ssim_1={arr[:, 0].mean():.4f} ssim_2={arr[:, 1].mean():.4f} "
            f"psnr_1={arr[:, 2].mean():.2f} psnr_2={arr[:, 3].mean():.2f}"
        )


if __name__ == "__main__":
    main()
