"""Convert a JAX package train state into a port checkpoint:

    python -m shineon_tpu_torch.tools.convert_jax_state --model MODEL \
        --npz state.npz --out DIR [train options]

``state.npz`` is the JAX ``TrainState`` flattened to '/'-joined paths (on a
host with JAX and orbax; the README gives the lines that dump an orbax
checkpoint to it). The model is built from the train options (``--model``,
``--dataset`` and what follows on the command line, on the CPU), its
``init_state`` is the template, :func:`shineon_tpu_torch.convert.load_jax_train_state`
fills it (parameters, statistics, Adam's count and moments, the
accumulator, the step) and it is written to ``DIR/state.pt``: ``python -m
shineon_tpu_torch.train --checkpoint DIR`` resumes from it, ``python -m
shineon_tpu_torch.test --checkpoint DIR`` exports from it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from shineon_tpu_torch.convert import load_jax_train_state


def convert_state(model_name: str, npz: str, out: str, option_argv=(), dataset="vvt") -> str:
    from shineon_tpu_torch.models import find_model_using_name
    from shineon_tpu_torch.options import TrainOptions
    from shineon_tpu_torch.training.checkpointing import save_checkpoint

    opt = TrainOptions().parse(["--model", model_name, "--dataset", dataset, "--name",
                                "converted", *option_argv, "--gpu_ids", "-1"])
    model = find_model_using_name(opt.model)(opt, "cpu")
    template = model.init_state(torch.Generator().manual_seed(420), 1)
    with np.load(npz) as flat:
        load_jax_train_state(dict(flat), template)
    return save_checkpoint(out, template)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", required=True)
    parser.add_argument("--npz", required=True, help="the flattened JAX TrainState")
    parser.add_argument("--out", required=True, help="the port checkpoint's directory")
    parser.add_argument("--dataset", default="vvt")
    args, option_argv = parser.parse_known_args(argv)
    out = convert_state(args.model, args.npz, args.out, option_argv, args.dataset)
    print(f"converted {args.npz} -> {out}")


if __name__ == "__main__":
    main()
