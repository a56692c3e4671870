"""GAN training options (counterpart of shineon_tpu/options/gan_options.py;
reference options/gan_options.py:6-25)."""

from __future__ import annotations

import argparse


def modify_commandline_options(parser: argparse.ArgumentParser, is_train: bool):
    from shineon_tpu_torch.networks.loss import GANLoss

    if is_train:
        parser.add_argument("--gan_mode", default="hinge", choices=GANLoss.AVAILABLE_MODES)
        parser.add_argument(
            "--lr_D", type=float, default=3e-4,
            help="Learning rate for Discriminators (TTUR; Heusel et al. 2017)",
        )
        parser.add_argument(
            "--no_ganFeat_loss", action="store_true",
            help="Disable GAN feature matching in loss.",
        )
        parser.add_argument(
            "--reference_gan_semantics", action="store_true",
            help="Reproduce the reference's generator adversarial terms "
            "exactly: the criterion is fed the REAL-branch predictions "
            "(reference sams_model.py:616-620, 651-655), whose gradient "
            "w.r.t. the generator is zero. Default uses standard hinge-GAN "
            "semantics (fake-branch predictions) so the adversarial term "
            "actually trains G.",
        )
    return parser
