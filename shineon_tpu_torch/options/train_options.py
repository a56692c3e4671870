"""Training options (counterpart of shineon_tpu/options/train_options.py;
reference options/train_options.py:7-51)."""

from __future__ import annotations

import argparse

from shineon_tpu_torch.options.base_options import BaseOptions


class TrainOptions(BaseOptions):
    def initialize(self, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        parser = BaseOptions.initialize(self, parser)
        # data
        parser.add_argument(
            "--no_shuffle", action="store_true", help="keep the sample order fixed (no shuffling)"
        )
        # checkpoints
        parser.add_argument(
            "--save_count", type=int, default=10000,
            help="unconditional checkpoint cadence, in steps",
        )
        parser.add_argument(
            "--val_check_interval", "--val_frequency", dest="val_check_interval", type=str,
            default="0.125",  # parsed later into int or float based on "."
            help="If float, validate (and checkpoint) after this fraction of an epoch. "
            "If int, validate after this many batches.",
        )
        # optimization
        parser.add_argument("--lr", type=float, default=1e-4, help="initial learning rate for adam")
        parser.add_argument(
            "--keep_epochs", type=int, default=5,
            help="epochs at the initial learning rate before decay starts",
        )
        parser.add_argument(
            "--decay_epochs", type=int, default=5,
            help="epochs over which the learning rate decays linearly to 0",
        )
        parser.add_argument(
            "--accumulated_batches", type=int, default=1,
            help="number of batch gradients to accumulate before stepping the optimizer",
        )
        self.is_train = True
        return parser
