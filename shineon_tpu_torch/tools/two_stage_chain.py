"""The inference chain of the reference, end to end (counterpart of
tools/two_stage_chain.py; reference docs/2_inference.md:27-39): the GMM's
warp export feeds TOM through ``warp_cloth_dir``.

Stage 1 fits the GMM briefly (``Trainer.fit``), then ``Trainer.test``
exports ``warp-cloth/`` PNGs of the test split (warp_model.py:174-); a
second export must skip every file. Stage 2 fits TOM with
``warp_cloth_dir`` at that tree, the dataset resolving each frame's warped
cloth from the stage-1 files (vvt_dataset.py:133-147 of the reference),
exports its ``reconstruction/`` frames and scores them against the
center-cropped ground truth: the mean SSIM and PSNR of
calculate_metrics.py (``data_range`` the generated frame's range). The
synthetic VVT trees hold no ``warp-cloth`` tree, so stage 2 can only read
stage 1's files. VVT, because the VITON layout reads ``warp-cloth/`` from
its own tree and has no densepose (TOM's documented person inputs).

    python3 -m shineon_tpu_torch.tools.two_stage_chain [--height 256 --width 192]

Runs at the documented ``gmm_options`` and ``tom_options`` (the dataset
VVT), on the card unless ``--device cpu``; prints one JSON line with the
JAX tool's field names.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
import shutil
import tempfile

import numpy as np
import torch
from PIL import Image

from shineon_tpu_torch.options import gmm_options, tom_options
from shineon_tpu_torch.tools.synthetic_data import make_vvt_tree
from shineon_tpu_torch.utils.metrics import peak_signal_noise_ratio, structural_similarity


def _fit(model_cls, builder, kw, device):
    """(model, state, trainer) after a fit at ``kw``."""
    from shineon_tpu_torch.training.loop import Trainer

    opt = builder(**kw)
    model = model_cls(opt, device)
    trainer = Trainer(opt, device=device)
    return model, trainer.fit(model), trainer


def _export(model, builder, kw, state, result_dir, device) -> None:
    """``Trainer.test`` over the test split into ``result_dir``."""
    from shineon_tpu_torch.training.loop import Trainer

    opt = builder(**{**kw, "is_train": False, "result_dir": result_dir, "checkpoint": ""})
    model.override_hparams(opt)
    Trainer(opt, device=device).test(model, state)


def _crop_gt(src: str, dst: str, width: int, height: int) -> None:
    """The ground-truth frames center-cropped as the data pipeline crops."""
    for vid in sorted(os.listdir(src)):
        os.makedirs(osp.join(dst, vid), exist_ok=True)
        for f in sorted(os.listdir(osp.join(src, vid))):
            with Image.open(osp.join(src, vid, f)) as img:
                arr = np.asarray(img.convert("RGB"))
            y0, x0 = max((arr.shape[0] - height) // 2, 0), max((arr.shape[1] - width) // 2, 0)
            Image.fromarray(arr[y0:y0 + height, x0:x0 + width]).save(osp.join(dst, vid, f))


def score(gt_dir: str, generated_dir: str):
    """(frames, mean SSIM, mean PSNR) of every generated frame that has a
    ground truth, as calculate_metrics.py scores them."""
    ssims, psnrs = [], []
    for vid in sorted(os.listdir(generated_dir)):
        for f in sorted(os.listdir(osp.join(generated_dir, vid))):
            gt_path = osp.join(gt_dir, vid, f)
            if not osp.exists(gt_path):
                continue
            with Image.open(gt_path) as a, Image.open(osp.join(generated_dir, vid, f)) as b:
                gt = np.asarray(a.convert("RGB"))
                gen = np.asarray(b.convert("RGB"))
            data_range = float(gen.max()) - float(gen.min())
            ssims.append(structural_similarity(gt, gen, data_range=data_range, multichannel=True))
            psnrs.append(peak_signal_noise_ratio(gt, gen, data_range=data_range))
    return len(ssims), float(np.mean(ssims)), float(np.mean(psnrs))


def run_chain(fine_height: int = 256, fine_width: int = 192, frames_per_video: int = 8,
              batch_size: int = 8, warp_epochs: int = 1, tom_epochs: int = 1,
              limit_train_batches: str = "1.0", workdir: str | None = None, device="cuda",
              gmm_overrides: dict | None = None, tom_overrides: dict | None = None) -> dict:
    """The chain over synthetic VVT trees (two videos of ``frames_per_video``
    frames, train and test); the GMM and TOM at their documented options
    with ``gmm_overrides`` and ``tom_overrides``. Returns the JAX tool's
    fields, plus the steps and test batches of TOM (``tom_train_steps``,
    ``tom_test_batches``)."""
    from shineon_tpu_torch.models.unet_mask_model import UnetMaskModel
    from shineon_tpu_torch.models.warp_model import WarpModel

    workdir = workdir or tempfile.mkdtemp(prefix="shineon_chain_")
    data_root = osp.join(workdir, "vvt")
    if not osp.isdir(osp.join(data_root, "train")):
        for mode in ("train", "test"):
            make_vvt_tree(data_root, n_videos=2, frames=frames_per_video, datamode=mode, seed=7,
                          height=fine_height, width=fine_width)
            shutil.rmtree(osp.join(data_root, mode, "warp-cloth"))
    common = dict(dataset="vvt", vvt_dataroot=data_root, fine_height=fine_height,
                  fine_width=fine_width, batch_size=batch_size, workers=0,
                  experiments_dir=osp.join(workdir, "exp"), val_check_interval="1000000",
                  display_count=1000000, save_count=1000000, val_fraction=0.1,
                  limit_train_batches=limit_train_batches)

    # stage 1: fit the GMM briefly, export warp-cloth/, export again
    warp_kw = dict(common, name="chain_warp", keep_epochs=warp_epochs, decay_epochs=0,
                   **(gmm_overrides or {}))
    warp_model, warp_state, _ = _fit(WarpModel, gmm_options, warp_kw, device)
    warp_results = osp.join(workdir, "results_warp")
    _export(warp_model, gmm_options, warp_kw, warp_state, warp_results, device)
    warp_cloth_dirs = glob.glob(osp.join(warp_results, "chain_warp", "*", "test", "*",
                                         "warp-cloth"))
    assert warp_cloth_dirs, f"stage 1 exported nothing under {warp_results}"
    warp_cloth_dir = warp_cloth_dirs[0]
    stage1_files = sorted(glob.glob(osp.join(warp_cloth_dir, "*", "*.png")))
    assert stage1_files, f"no warp-cloth PNGs under {warp_cloth_dir}"
    stage1_samples = len(warp_model.train_dataset)
    mtimes = {f: os.stat(f).st_mtime_ns for f in stage1_files}
    _export(warp_model, gmm_options, warp_kw, warp_state, warp_results, device)
    after = sorted(glob.glob(osp.join(warp_cloth_dir, "*", "*.png")))
    resumed_untouched = after == stage1_files and all(
        os.stat(f).st_mtime_ns == m for f, m in mtimes.items())
    del warp_model, warp_state

    # stage 2: TOM reads warp_cloth_dir, fits briefly, exports, is scored
    tom_kw = dict(common, name="chain_tom", keep_epochs=tom_epochs, decay_epochs=0,
                  warp_cloth_dir=warp_cloth_dir, **(tom_overrides or {}))
    tom_model, tom_state, tom_trainer = _fit(UnetMaskModel, tom_options, tom_kw, device)
    tom_results = osp.join(workdir, "results_tom")
    _export(tom_model, tom_options, tom_kw, tom_state, tom_results, device)
    test_batches = len(tom_model.test_dataloader())
    recon = glob.glob(osp.join(tom_results, "chain_tom", "*", "test", "*", "reconstruction"))
    assert recon, f"stage 2 exported nothing under {tom_results}"
    gt = osp.join(workdir, "gt_cropped")
    _crop_gt(osp.join(data_root, "test", "test_frames"), gt, fine_width, fine_height)
    frames, ssim, psnr = score(gt, recon[0])
    return {
        "stage1_warp_cloth_files": len(stage1_files),
        "stage1_samples": stage1_samples,
        "stage1_resume_skipped_all": bool(resumed_untouched),
        "warp_cloth_dir": warp_cloth_dir,
        "frames_scored": frames,
        "ssim_tryon": ssim,
        "psnr_tryon": psnr,
        "resolution": f"{fine_width}x{fine_height}",
        "workdir": workdir,
        "tom_train_steps": tom_trainer.global_step,
        "tom_test_batches": test_batches,
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--frames", type=int, default=8, help="frames a video")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--warp_epochs", type=int, default=1)
    p.add_argument("--tom_epochs", type=int, default=1)
    p.add_argument("--workdir", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("two_stage_chain: no CUDA device (pass --device cpu to run on the CPU)")
    result = run_chain(args.height, args.width, args.frames, args.batch_size, args.warp_epochs,
                       args.tom_epochs, workdir=args.workdir, device=args.device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
