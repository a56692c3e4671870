"""The QA loop on the port: train, export, score (counterpart of the
repository's tools/e2e_quality.py; the reference's train.py -> test.py ->
folders -> calculate_metrics.py, calculate_metrics.py:64-144 and
docs/2_inference.md:9-56):

    python -m shineon_tpu_torch.tools.e2e_quality --model sams [--remat] \
        [--height 256 --width 192 --frames 24 --n_frames 3 --batch_size 4 \
         --epochs 16 --lr 2e-4] [--int8] [--gpu_ids -1]

It writes a synthetic VVT tree (tools/synthetic_data.py, the same files
in train/ and test/, two videos: the video-level validation split gives
vid0 to training and to the test export, vid1 to validation), exports the
test clips' last frames with the Trainer's initial state (a generator
seeded with 420), trains with ``shineon_tpu_torch.train.run`` (the command
line's entry: ``Trainer.fit``), exports again with the trained state, and,
for each entry of ``extra_exports`` (``{"int8": {"int8_spade": True}}``),
once more with the same trained state under those options. Each export is
``Trainer.test``. The ground-truth frames are centre-cropped to the run's
size, as the data pipeline crops them, and every export is scored against
them by ``python -m shineon_tpu_torch.calculate_metrics`` in a subprocess.
Returns, and prints as JSON, the JAX tool's fields (``ssim_init``,
``ssim_trained``, ``psnr_init``, ``psnr_trained``, ``frames_scored``,
``train_steps``, ``ssim_<variant>``, ``psnr_<variant>``, ...) and the
wall seconds of each stage. Runs on the card unless ``device="cpu"``
(``--gpu_ids -1``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import glob
import io
import json
import os
import os.path as osp
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

# the JAX tool's namespace (tools/e2e_quality.py::_namespace), over the
# command line's defaults for the model
BASE = dict(
    model="sams", dataset="vvt", datamode="train", is_train=True,
    person_inputs=["agnostic", "densepose", "flow"], cloth_inputs=["cloth"],
    fine_height=256, fine_width=192, radius=5, val_fraction=0.1,
    cloth_mask_threshold=240, visualize_flow=False, image_scale=1,
    n_frames_total=3, n_frames_now=3, flow_warp=True,
    encoder_input="flow", activation="relu",
    norm_G="spectralspadesyncbatch3x3", ngf_base=2, ngf_pow_outer=6,
    ngf_pow_inner=10, ngf_pow_step=1, num_middle=3,
    attention_middle_indices=(), attention_decoder_indices=(),
    init_type="xavier", init_variance=0.02,
    num_D=2, ndf=64, n_layers_D=4, norm_D="spectralinstance",
    gan_mode="hinge", lr=1e-4, lr_D=3e-4, no_ganFeat_loss=False,
    wt_l1=1.0, wt_vgg=1.0, wt_multiscale=1.0, wt_temporal=1.0,
    keep_epochs=5, decay_epochs=5, accumulated_batches=1,
    batch_size=4, workers=0, no_shuffle=False,
    limit_train_batches="1.0", limit_val_batches="1.0",
    ngf=64, self_attn=False, num_attn=2, precision=32,
    tryon_list=None, random_tryon=False, warp_cloth_dir=None,
    pen_flow_mask=0.25,
    display_count=1000000, save_count=1000000,
    checkpoint="", fast_dev_run=False, loglevel="warning",
    val_check_interval="1.0", data_list="train_pairs.txt",
    # no pretrained VGG19 here: the random-filter perceptual loss
    allow_random_vgg=True,
)
# TOM's differences (tools/e2e_quality.py:140-145)
UNET_MASK = dict(person_inputs=["agnostic", "densepose"], n_frames_total=1, n_frames_now=1,
                 flow_warp=False)
SUMMARY = re.compile(r"frames=(\d+) ssim_1=(\S+) ssim_2=(\S+) psnr_1=(\S+) psnr_2=(\S+)")


def namespace(train: bool, **kw) -> argparse.Namespace:
    """The command line's namespace for ``--model kw["model"] --dataset vvt``
    (train or test options), with :data:`BASE` and ``kw`` over it."""
    from shineon_tpu_torch.options import TestOptions, TrainOptions

    model = kw.get("model", BASE["model"])
    with contextlib.redirect_stdout(io.StringIO()):  # the parse prints every option
        opt = (TrainOptions() if train else TestOptions()).parse(
            ["--model", model, "--dataset", "vvt", "--name", "e2e"])
    vars(opt).update({**BASE, **kw, "is_train": train})
    return opt


def crop_gt(src: str, dst: str, width: int, height: int) -> None:
    """Centre-crop the ground-truth frames to the run's size, the crop the
    data pipeline applies (the reference crops, never resizes:
    tryon_dataset.py:84-111); the identity at 256x192."""
    from PIL import Image

    for vid in sorted(os.listdir(src)):
        os.makedirs(osp.join(dst, vid), exist_ok=True)
        for f in sorted(os.listdir(osp.join(src, vid))):
            arr = np.asarray(Image.open(osp.join(src, vid, f)).convert("RGB"))
            y0 = max((arr.shape[0] - height) // 2, 0)
            x0 = max((arr.shape[1] - width) // 2, 0)
            Image.fromarray(arr[y0:y0 + height, x0:x0 + width]).save(osp.join(dst, vid, f))


def export(opt_kw: dict, state, result_dir: str, device) -> str:
    """``Trainer.test``'s export of ``state``'s networks (copied into an
    eval-mode model built from ``opt_kw``); returns the reconstruction
    folder."""
    from shineon_tpu_torch.models import find_model_using_name
    from shineon_tpu_torch.training.loop import Trainer

    eval_opt = namespace(False, **{**opt_kw, "datamode": "test", "no_shuffle": True,
                                   "result_dir": result_dir, "name": "e2e"})
    model = find_model_using_name(eval_opt.model)(eval_opt, device)
    model.override_hparams(eval_opt)
    template = model.make_state(1)
    for name, net in template.nets.items():
        net.module.load_state_dict(state.nets[name].module.state_dict())
    template.step = state.step
    Trainer(eval_opt, device).test(model, template)
    recon = glob.glob(osp.join(result_dir, "e2e", "*", "test", "*", "reconstruction"))
    if not recon:
        raise RuntimeError(f"no reconstruction export under {result_dir}")
    return recon[0]


def score(gt: str, dir1: str, name1: str, dir2: str, name2: str, outdir: str):
    """``calculate_metrics`` of two exports in a subprocess: (frames, ssim_1,
    ssim_2, psnr_1, psnr_2). PSNR may read -inf: a frame of one value (an
    untrained clip that blew up, clamped to black) has a data range of 0."""
    out = subprocess.run(
        [sys.executable, "-m", "shineon_tpu_torch.calculate_metrics", "-t", gt, "-g1", dir1,
         "-g2", dir2, "--experiment_one", name1, "--experiment_two", name2, "--result", outdir,
         "--no_video"], capture_output=True, text=True, timeout=1200, cwd=REPO)
    if out.returncode != 0:
        raise RuntimeError(f"calculate_metrics failed: {out.stderr[-4000:]}")
    m = SUMMARY.search(out.stdout)
    if m is None:
        raise RuntimeError(f"metrics summary not found in: {out.stdout!r}")
    return (int(m.group(1)), *(float(v) for v in m.groups()[1:]))


def run_e2e(model_name: str = "sams", fine_height: int = 256, fine_width: int = 192,
            n_frames: int = 3, frames_per_video: int = 24, batch_size: int = 4,
            epochs: int = 16, lr: float = 2e-4, workdir: str | None = None,
            arch_overrides: dict | None = None, extra_exports: dict | None = None,
            precision: int = 32, device="cuda", observe=None) -> dict:
    """The loop (module docstring). ``extra_exports``: {variant: {option:
    value}}, re-exports of the trained state under those options, scored
    against the trained export as ``ssim_<variant>`` / ``psnr_<variant>``.
    ``observe(stage)``, when given, is a context manager entered around each
    stage ("export_init", "fit", "export_trained", "export_<variant>")."""
    from shineon_tpu_torch import train as entry
    from shineon_tpu_torch.models import find_model_using_name
    from shineon_tpu_torch.serving import resolve_device
    from shineon_tpu_torch.tools.synthetic_data import make_vvt_tree

    device = resolve_device(device)
    observe = observe or (lambda stage: contextlib.nullcontext())
    seconds = {}

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        with observe(name):
            yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0

    workdir = workdir or tempfile.mkdtemp(prefix="shineon_e2e_")
    data_root = osp.join(workdir, "vvt")
    if not osp.isdir(osp.join(data_root, "train")):
        for datamode in ("train", "test"):  # the same seed: the test export sees the train clips
            make_vvt_tree(data_root, n_videos=2, frames=frames_per_video, datamode=datamode,
                          seed=7, height=fine_height, width=fine_width)
    if model_name not in ("sams", "unet_mask"):
        raise ValueError(model_name)
    arch = {**(UNET_MASK if model_name == "unet_mask" else {}), **(arch_overrides or {})}
    opt_kw = dict(
        model=model_name, vvt_dataroot=data_root, fine_height=fine_height,
        fine_width=fine_width, n_frames_total=n_frames, n_frames_now=n_frames,
        batch_size=batch_size, lr=lr, precision=precision, keep_epochs=epochs,
        decay_epochs=epochs, experiments_dir=osp.join(workdir, "exp"), name="e2e",
        gpu_ids=[] if device.type == "cpu" else [device.index or 0],
        # an overfit harness: no mid-run validation (FINAL is still saved)
        val_check_interval="1000000")
    opt_kw.update(arch)  # the model family's defaults and the caller's overrides win

    # export at init: the Trainer's own initial state (seed 420)
    train_opt = namespace(True, **opt_kw)
    model = find_model_using_name(model_name)(train_opt, device)
    model.setup("fit")
    state0 = model.init_state(torch.Generator().manual_seed(420),
                              max(len(model.train_dataloader()), 1))
    with stage("export_init"):
        init_dir = export(opt_kw, state0, osp.join(workdir, "results_init"), device)
    del model, state0
    gc.collect()

    with stage("fit"):
        state = entry.run(train_opt, train=True)
    with stage("export_trained"):
        trained_dir = export(opt_kw, state, osp.join(workdir, "results_trained"), device)
    variant_dirs = {}
    for name, options in (extra_exports or {}).items():
        with stage(f"export_{name}"):
            variant_dirs[name] = export({**opt_kw, **options}, state,
                                        osp.join(workdir, f"results_{name}"), device)
    steps = int(state.step)
    del state
    gc.collect()

    gt = osp.join(workdir, "gt_cropped")
    crop_gt(osp.join(data_root, "test", "test_frames"), gt, fine_width, fine_height)
    t0 = time.perf_counter()
    frames, ssim_init, ssim_trained, psnr_init, psnr_trained = score(
        gt, init_dir, "init", trained_dir, "trained", osp.join(workdir, "metrics_out"))
    extra = {}
    for name, vdir in variant_dirs.items():
        _, _, s, _, p = score(gt, trained_dir, "trained", vdir, name,
                              osp.join(workdir, f"metrics_{name}"))
        extra[f"ssim_{name}"], extra[f"psnr_{name}"] = s, p
    seconds["score"] = time.perf_counter() - t0
    return extra | {
        "model": model_name, "frames_scored": frames, "train_steps": steps,
        "resolution": f"{fine_width}x{fine_height}",
        "ssim_init": ssim_init, "ssim_trained": ssim_trained,
        "psnr_init": psnr_init, "psnr_trained": psnr_trained,
        "workdir": workdir, "exports": {"init": init_dir, "trained": trained_dir,
                                        **variant_dirs},
        "seconds": seconds,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=["sams", "unet_mask"], default="sams")
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--frames", type=int, default=24, help="frames in the synthetic video")
    p.add_argument("--n_frames", type=int, default=3, help="clip length")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--epochs", type=int, default=16, help="keep epochs (= decay epochs)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--workdir", default=None)
    p.add_argument("--remat", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="also export the trained state with int8 serving and score it")
    p.add_argument("--gpu_ids", default="0", help="a CUDA device index; -1 runs on the CPU")
    args = p.parse_args(argv)
    device = "cpu" if int(args.gpu_ids) < 0 else f"cuda:{args.gpu_ids}"
    result = run_e2e(
        model_name=args.model, fine_height=args.height, fine_width=args.width,
        n_frames=args.n_frames, frames_per_video=args.frames, batch_size=args.batch_size,
        epochs=args.epochs, lr=args.lr, workdir=args.workdir,
        arch_overrides={"remat": True} if args.remat else {},
        extra_exports={"int8": {"int8_spade": True}} if args.int8 else None, device=device)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
