"""Test and export options (counterpart of shineon_tpu/options/test_options.py;
reference options/test_options.py:5-32)."""

from __future__ import annotations

import argparse

from shineon_tpu_torch.options.base_options import BaseOptions


class TestOptions(BaseOptions):
    def initialize(self, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        parser = BaseOptions.initialize(self, parser)
        parser.set_defaults(datamode="test")
        parser.add_argument(
            "--no_shuffle", action="store_true", default=True,
            help="don't shuffle input data (always on at test time)",
        )
        self.is_train = False
        parser.add_argument(
            "--result_dir", type=str, default="test_results",
            help="directory to write exported test outputs into",
        )
        parser.add_argument(
            "--tryon_list",
            help="Use a CSV file to specify what cloth should go on each person. "
            "The CSV should have two columns: CLOTH_PATH and PERSON_ID.",
        )
        parser.add_argument(
            "--random_tryon", action="store_true",
            help="Randomly choose cloth-person pairs for try-on.",
        )
        parser.add_argument(
            "--allow_random_init", action="store_true",
            help="explicitly allow the test entry to run WITHOUT --checkpoint "
            "(exports noise frames from a random init; useful only for "
            "pipeline smoke tests). Without this flag, it refuses to "
            "evaluate an un-restored model (reference train.py:39-45 "
            "requires a checkpoint to test).",
        )
        parser.add_argument(
            "--int8_spade", action="store_true",
            help="serve the SPADE gamma/beta convs quantized: the int8 MultiSPADE chain "
            "and the int8 3x3 conv. An option of this run only; no environment "
            "variable is read or set.",
        )
        parser.add_argument(
            "--int8_min_channels", type=int, default=64,
            help="with --int8_spade, the fewest channels a 3x3 conv of the generator needs "
            "to run in int8 (the JAX package's SHINEON_INT8_MIN_CH)",
        )
        return parser
