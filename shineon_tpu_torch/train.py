"""The training and test entry (counterpart of the JAX package's train.py;
reference train.py:32-145), on the port:

    python -m shineon_tpu_torch.train --model {warp,unet_mask,sams} \
        --dataset {viton,vvt,mpv,viton_vvt_mpv} [--gpu_ids -1] ...

It parses the command line (``options.TrainOptions``, or
``options.TestOptions`` for ``python -m shineon_tpu_torch.test``), builds
the model, restores ``--checkpoint`` when one is given, and runs
``Trainer.fit``, or for a test run ``Trainer.test``'s export. The device is
the first of ``--gpu_ids`` (``cuda:<id>``); ``--gpu_ids -1`` is the only way
to run on the CPU, and a CUDA device that is not there raises.
"""

from __future__ import annotations

import logging

import torch

from shineon_tpu_torch.models import find_model_using_name
from shineon_tpu_torch.options import TestOptions, TrainOptions
from shineon_tpu_torch.training.checkpointing import load_checkpoint
from shineon_tpu_torch.training.loop import Trainer
from shineon_tpu_torch.utils.log import get_logger

logger = get_logger()

SEED = 420  # the reference's seed (train.py:29)


def device_of(opt) -> torch.device:
    """The first of ``opt.gpu_ids`` as a CUDA device, or the CPU for none."""
    if not opt.gpu_ids:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--gpu_ids {','.join(map(str, opt.gpu_ids))} asks for a CUDA "
                           f"device and CUDA is not available; pass --gpu_ids -1 to run on "
                           f"the CPU")
    return torch.device("cuda", opt.gpu_ids[0])


def main(train: bool = True, argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` when None) and train, or test; returns
    the train state."""
    options_obj = TrainOptions() if train else TestOptions()
    opt = options_obj.parse(argv)
    logger.setLevel(getattr(logging, opt.loglevel.upper()))

    if not train and not opt.checkpoint and not opt.allow_random_init:
        # the reference refuses to test without a checkpoint (train.py:39-45)
        raise SystemExit(
            "test.py needs --checkpoint (no model to evaluate); pass "
            "--allow_random_init to export from a random initialization anyway"
        )

    device = device_of(opt)
    model_class = find_model_using_name(opt.model)
    model = model_class(opt, device)
    state = None
    if opt.checkpoint:
        # a template at one step an epoch: fit sets its loader's schedule
        template = model.init_state(torch.Generator().manual_seed(SEED), 1)
        state = load_checkpoint(opt.checkpoint, template, modules_only=not train)
        logger.info(f"RESUMED {model_class.__name__} from checkpoint: {opt.checkpoint}")
    else:
        logger.info(f"INITIALIZED new {model_class.__name__}")
    model.override_hparams(opt)

    trainer = Trainer(opt, device)
    if train:
        state = trainer.fit(model, resume_state=state)
    else:
        print("Testing........")
        print(opt)
        if state is None:
            logger.warning("testing a RANDOMLY INITIALIZED model (--allow_random_init)")
            state = model.init_state(torch.Generator().manual_seed(SEED), 1)
        trainer.test(model, state)
    logger.info(f"Finished {opt.model}, named {opt.name}!")
    return state


if __name__ == "__main__":
    main(train=True)
