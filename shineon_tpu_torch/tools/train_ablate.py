"""Per-lever attribution of the SAMS training step's wall clock
(counterpart of tools/bench_train_ablate.py).

    python3 -m shineon_tpu_torch.tools.train_ablate [--configs exact fast ...]
        [--steps 8] [--device cpu]

The production step (``bench.build_train``: batch 4, 256x192, 5-frame
clips, remat, bf16) under the JAX tool's ablations:

  exact    the reference-exact per-optimizer step (the command line's default)
  fast     ``fast_gan_step``: both discriminator updates reuse the G step's clip
  no_vgg   ``wt_vgg=0``: the VGG term's forward and backward cost
  f32_vgg  the perceptual loss over an f32 VGG19 (the step's default runs
           it at the compute dtype, bf16), swapped in after the model is
           built, with the same filters, and the step rebuilt
  num_D_1  ``num_D=1``: one multiscale discriminator scale instead of two

Each is timed by ``bench.time_train_steps``: the median, with min and max,
of ``bench.REPEATS`` windows of ``--steps`` chained steps after a warm-up
step, each to a synchronize and a fetch of the loss (the JAX tool took the
best of 2). Prints one JSON line a config (``step_s`` and ``fps`` as the
JAX tool, the spread, peak device memory, the last step's losses) and an
``ablation`` line with the card's nvidia-smi line. Runs on the card;
``--device cpu`` runs it on the CPU (host times: not device metrics).
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from shineon_tpu_torch.bench import (
    REPEATS,
    TRAIN_BATCH,
    TRAIN_STEPS,
    build_train,
    time_train_steps,
)
from shineon_tpu_torch.networks.loss import VGGLoss
from shineon_tpu_torch.networks.vgg import Vgg19Features
from shineon_tpu_torch.tools import card_line, device_or_exit

CONFIGS = {
    "exact": {},
    "fast": {"fast_gan_step": True},
    "no_vgg": {"wt_vgg": 0.0},
    "f32_vgg": {},  # the VGG swapped after the build
    "num_D_1": {"num_D": 1},
}


def f32_vgg(model) -> None:
    """Swap the model's perceptual loss for one over an f32 VGG19 with the
    same filters (the JAX tool's ``VGGLoss(dtype=None)``)."""
    bf16 = model.criterion_vgg.model
    vgg = Vgg19Features(dtype=None).to(next(bf16.parameters()).device)
    vgg.load_state_dict(bf16.state_dict())
    model.criterion_vgg = VGGLoss(vgg.requires_grad_(False), model.criterion_vgg.layids)


def build_config(name: str, batch: int = TRAIN_BATCH, device="cuda", **overrides):
    """``bench.build_train`` with the config's options (``overrides``
    replace any): (model, state, step, raw_batch, n_frames)."""
    if name not in CONFIGS:
        raise ValueError(f"unknown config {name!r}; available: {sorted(CONFIGS)}")
    model, state, step, raw, n_frames = build_train(batch, device, **CONFIGS[name], **overrides)
    if name == "f32_vgg":
        f32_vgg(model)
        step = model.make_train_step()
    return model, state, step, raw, n_frames


def measure_config(name: str, batch: int = TRAIN_BATCH, device="cuda", steps: int = TRAIN_STEPS,
                   repeats: int = REPEATS, **overrides) -> dict:
    """One config's line: step seconds (median, min, max), frames/s, peak
    device GiB (the card only) and the last step's losses."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    model, state, step, raw, n_frames = build_config(name, batch, device, **overrides)
    last = {}

    def recorded(s, b):
        last.update(step(s, b))
        return last

    median, lo, hi = time_train_steps(recorded, state, raw, repeats, steps)
    losses = {k: float(v) for k, v in last.items() if k.startswith("loss")}
    if not all(math.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"{name}: a loss is not finite: {losses}")
    out = {"config": name, "step_s": median, "fps": batch * n_frames / median,
           "step_s_min": lo, "step_s_max": hi,
           "peak_mem_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                            if device.type == "cuda" else None),
           "num_D": model.multiscale_discriminator.num_D, "losses": losses}
    del model, state, step, raw
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", nargs="*", default=None, help=f"of {list(CONFIGS)}")
    p.add_argument("--steps", type=int, default=TRAIN_STEPS)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    names = args.configs or list(CONFIGS)
    unknown = [n for n in names if n not in CONFIGS]
    if unknown:
        p.error(f"unknown --configs {unknown}; available: {sorted(CONFIGS)}")
    device = device_or_exit(args.device, "train_ablate")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for name in names:
        line = measure_config(name, device=device, steps=args.steps)
        results[name] = {k: v for k, v in line.items() if k != "config"}
        print(json.dumps(line), flush=True)
    print(json.dumps({"ablation": results, "batch": TRAIN_BATCH, "steps_per_window": args.steps,
                      "repeats": REPEATS, "card": card_line() if device.type == "cuda" else None,
                      "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                 else "cpu"), "mode": "bf16"}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
