"""SSIM/PSNR against training length for the port's QA loop (counterpart
of the repository's tools/quality_curve.py):

    python -m shineon_tpu_torch.tools.quality_curve --epochs 35 100 250 \
        [--production [--overfit_objective]] [--workdir DIR] [--gpu_ids -1]

Runs :func:`shineon_tpu_torch.tools.e2e_quality.run_e2e` at each epoch
count (seeded training on the same synthetic tree: each run is a prefix of
one trajectory) and prints one JSON point a run, then the curve. By
default the tiny SAMS overfit configuration (:data:`TINY_SAMS`, 32x24,
3-frame clips, lr 1e-3). ``--production`` runs the production
configuration instead (256x192, 5-frame clips, the full generator, remat,
bf16, the exact GAN step, lr 2e-4) and exports the last point's trained
state with int8 serving too; ``--overfit_objective`` swaps the GAN loss
weights for the overfit objective (wt_vgg 0, adversarial weights 0.3, lr
1e-3).
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

from shineon_tpu_torch.tools.e2e_quality import run_e2e

TINY_SAMS = {
    "ngf_pow_outer": 3, "ngf_pow_inner": 5, "num_middle": 1,
    "ndf": 8, "n_layers_D": 3, "wt_vgg": 0.0,
    "wt_multiscale": 0.3, "wt_temporal": 0.3,
}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, nargs="*", default=[35, 100, 250])
    p.add_argument("--workdir", default=None)
    p.add_argument("--production", action="store_true",
                   help="the production configuration; the last point also exports with "
                   "int8 serving")
    p.add_argument("--overfit_objective", action="store_true",
                   help="with --production: wt_vgg 0, adversarial weights 0.3, lr 1e-3")
    p.add_argument("--gpu_ids", default="0", help="a CUDA device index; -1 runs on the CPU")
    args = p.parse_args(argv)
    device = "cpu" if int(args.gpu_ids) < 0 else f"cuda:{args.gpu_ids}"

    curve = []
    for i, ep in enumerate(args.epochs):
        last = i == len(args.epochs) - 1
        workdir = None if args.workdir is None else osp.join(args.workdir, f"ep{ep}")
        if args.production:
            arch = {"remat": True, "display_count": 24}
            lr = 2e-4
            if args.overfit_objective:
                arch.update(wt_vgg=0.0, wt_multiscale=0.3, wt_temporal=0.3)
                lr = 1e-3
            r = run_e2e(model_name="sams", fine_height=256, fine_width=192, n_frames=5,
                        frames_per_video=24, batch_size=4, epochs=ep, lr=lr, precision=16,
                        workdir=workdir, arch_overrides=arch, device=device,
                        extra_exports={"int8": {"int8_spade": True}} if last else None)
        else:
            r = run_e2e(model_name="sams", fine_height=32, fine_width=24, n_frames=3,
                        frames_per_video=12, batch_size=4, epochs=ep, lr=1e-3,
                        workdir=workdir, arch_overrides=dict(TINY_SAMS), device=device)
        point = {"epochs": ep, "steps": r["train_steps"], "ssim": r["ssim_trained"],
                 "psnr": r["psnr_trained"], "ssim_init": r["ssim_init"]}
        point.update({k: r[k] for k in ("ssim_int8", "psnr_int8") if k in r})
        print(json.dumps(point), flush=True)
        curve.append(point)
    print(json.dumps({"curve": curve}))


if __name__ == "__main__":
    main()
