"""The networks' shared command-line options (counterpart of
shineon_tpu/networks/__init__.py; reference models/networks/__init__.py)."""

from __future__ import annotations

import argparse


def add_base_network_options(parser: argparse.ArgumentParser, is_train: bool):
    """--init_type and --init_variance (reference base_network.py:15-29)."""
    parser.add_argument(
        "--init_type", type=str, default="xavier",
        help="weight init scheme: normal, xavier, xavier_uniform, kaiming, or orthogonal",
    )
    parser.add_argument(
        "--init_variance", type=float, default=0.02,
        help="gain/std of the weight init distribution",
    )
    return parser


def add_discriminator_options(parser: argparse.ArgumentParser, is_train: bool):
    """The multiscale and n-layer discriminators' options."""
    parser.add_argument(
        "--netD_subarch", type=str, default="n_layer",
        help="conv depth of each PatchGAN discriminator",
    )
    parser.add_argument(
        "--num_D", type=int, default=2, help="discriminator count in the multiscale pyramid",
    )
    parser.add_argument("--n_layers_D", type=int, default=4, help="# layers in each discriminator")
    parser.add_argument("--ndf", type=int, default=64, help="num discriminator features")
    return parser


def modify_commandline_options(parser: argparse.ArgumentParser, is_train: bool):
    """The SAMS generator's options and, for training, the discriminators'."""
    from shineon_tpu_torch.networks.sams.sams_generator import SamsGenerator

    parser = SamsGenerator.modify_commandline_options(parser, is_train)
    if is_train:
        parser = add_discriminator_options(parser, is_train)
    return parser
