"""The command line's base options and its three-phase parse (counterpart
of shineon_tpu/options/base_options.py; reference
options/base_options.py:18-265).

The parse runs in three phases: the base options; then the chosen model's
``modify_commandline_options`` extends the parser and the command line is
parsed again with its defaults; then the chosen dataset's extends it, and
the final parse runs. A model or dataset may also change the default of a
shared option with ``parser.set_defaults``. After the parse, the model's
synonyms are resolved (gmm -> warp, tom and unet -> unet_mask),
``--gpu_ids`` becomes a list of ints, an integer ``val_check_interval`` is
clamped to an integer ``limit_train_batches`` (1 under ``--fast_dev_run``),
the person and cloth inputs are sorted, an unset ``n_frames_now`` is
``n_frames_total`` and SAMS's unset encoder map is its first person input.

The hardware options:
  --gpu_ids            comma list of CUDA device indices; the port runs on
                       one card, the first of them. ``-1`` (no index left)
                       runs on the CPU.
  --distributed_backend  "ddp" (the default): under torchrun, data
                       parallelism across the launched processes
                       (``parallel/ddp.py``); a process not started by a
                       launcher trains alone.
  --precision {16,32}  16 -> bfloat16 compute (parameters, losses, sampling
                       grids and norm statistics stay f32), 32 -> float32.

``--int8_spade`` (the test options') is an option of the namespace only:
the port reads and writes no environment variable for it, so one parse
cannot leak into the next.
"""

from __future__ import annotations

import argparse
import sys


class BaseOptions:
    def __init__(self):
        self.initialized = False
        self.is_train = None

    def initialize(self, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        parser.add_argument("--name", default="unnamed_experiment")
        # compute
        parser.add_argument(
            "--distributed_backend", default="ddp",
            help="how to do distributed multi-device training: under torchrun, 'ddp' trains "
            "data-parallel across the launched processes, one device each",
        )
        parser.add_argument(
            "--gpu_ids", default="0",
            help="comma list of CUDA device indices; the port runs on the first of them, "
            "and -1 runs on the CPU",
        )
        parser.add_argument(
            "-j", "--num_workers", "--workers", dest="workers", type=int, default=4
        )
        parser.add_argument("-b", "--batch_size", type=int, default=8)
        parser.add_argument("--activation", choices=("relu", "gelu", "swish", "sine"))
        parser.add_argument(
            "-fp", "--precision", type=int, dest="precision",
            help="16 -> bfloat16 compute, 32 -> float32 compute", choices=(16, 32), default=16,
        )
        # data
        parser.add_argument(
            "--dataset", choices=("viton", "viton_vvt_mpv", "vvt", "mpv"), default="vvt"
        )
        parser.add_argument("--datamode", default="train")
        parser.add_argument(
            "--model",
            help="model to run: 'warp' (synonym 'gmm'), 'unet_mask' "
            "(synonyms 'tom', 'unet'), or 'sams'.",
        )
        parser.add_argument(
            "--datacap", "--datacap_train", "--limit_train_batches",
            dest="limit_train_batches", default="1.0",
            help="limits the train loader to this many batches (int) or fraction (float)",
        )
        parser.add_argument(
            "--datacap_val", "--limit_val_batches", dest="limit_val_batches", default="1.0",
            help="limits the val loader to this many batches (int) or fraction (float)",
        )
        # logging
        parser.add_argument(
            "--experiments_dir", default="experiments",
            help="root directory for experiment logs and checkpoints",
        )
        parser.add_argument(
            "--checkpoint", type=str, default="",
            help="checkpoint path to initialize/resume from",
        )
        parser.add_argument(
            "--display_count", type=int, default=200,
            help="TensorBoard logging cadence, in steps",
        )
        parser.add_argument(
            "--loglevel", choices=("debug", "info", "warning", "error", "critical"),
            default="info", help="console logging verbosity",
        )
        # debug
        parser.add_argument(
            "--fast_dev_run", action="store_true",
            help="single-batch smoke run of the full pipeline",
        )
        self.initialized = True
        return parser

    def gather_options(self, argv=None) -> argparse.Namespace:
        """The three-phase parse: base, model, dataset."""
        from shineon_tpu_torch import datasets, models

        parser = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser = self.initialize(parser)
        opt, _ = parser.parse_known_args(argv)

        BaseOptions.apply_model_synonyms(opt)
        parser = models.get_option_setter(opt.model)(parser, self.is_train)
        opt, _ = parser.parse_known_args(argv)  # again, with the model's defaults

        parser = datasets.get_option_setter(opt.dataset)(parser, self.is_train)
        self.parser = parser
        return parser.parse_args(argv)

    def print_options(self, opt: argparse.Namespace) -> None:
        """Print every option, marking the values that are not defaults."""
        message = "----------------- Options ---------------\n"
        for k, v in sorted(vars(opt).items()):
            comment = ""
            default = self.parser.get_default(k)
            if v != default:
                comment = "\t[default: %s]" % str(default)
            message += "{:>25}: {:<30}{}\n".format(str(k), str(v), comment)
        message += "----------------- End -------------------"
        print(message)
        self.options_formatted_str = message

    def parse(self, argv=None) -> argparse.Namespace:
        """The parsed namespace of ``argv`` (``sys.argv[1:]`` when None)."""
        opt = self.gather_options(argv)
        opt.is_train = self.is_train
        BaseOptions.apply_ask_unnamed_experiment(opt, interactive=argv is None)
        BaseOptions.apply_model_synonyms(opt)
        BaseOptions.apply_gpu_ids(opt)
        BaseOptions.apply_val_check_ge_train_batch(opt)
        BaseOptions.apply_sort_inputs(opt)

        from shineon_tpu_torch.datasets.n_frames_interface import NFramesInterface
        from shineon_tpu_torch.models.sams_model import SamsModel

        NFramesInterface.apply_n_frames_now_default_total(opt)
        SamsModel.apply_default_encoder_input(opt)
        self.print_options(opt)
        self.opt = opt
        return self.opt

    @staticmethod
    def apply_ask_unnamed_experiment(opt, interactive=True):
        """Ask for an experiment name when a terminal runs the command line
        without ``--name`` (reference options/base_options.py:194-206)."""
        if not interactive or "--name" in sys.argv or not sys.stdin.isatty():
            return
        print("\nNo --name was given for this experiment. Enter one now, or press enter to "
              "keep the default (pass --name NAME to skip this prompt).")
        new_name = input(f"experiment name [{opt.name}]: ")
        print()
        if new_name:
            opt.name = new_name
            print(f"Using experiment name: {opt.name}")

    @staticmethod
    def apply_gpu_ids(opt):
        """"0,2" -> [0, 2]; negative ids are dropped ("-1" -> [], the CPU)."""
        str_ids = str(opt.gpu_ids).split(",")
        opt.gpu_ids = [int(s) for s in str_ids if s != "" and int(s) >= 0]

    @staticmethod
    def apply_model_synonyms(opt):
        """gmm -> warp, tom and unet -> unet_mask (reference
        options/base_options.py:223-234)."""
        opt.model = opt.model.lower()
        before = opt.model
        if opt.model == "gmm":
            opt.model = "warp"
        elif opt.model in ("tom", "unet"):
            opt.model = "unet_mask"
        if before != opt.model:
            print(f"--model {before} is a synonym; running --model {opt.model}")

    @staticmethod
    def apply_sort_inputs(opt):
        opt.person_inputs = sorted(opt.person_inputs)
        opt.cloth_inputs = sorted(opt.cloth_inputs)

    @staticmethod
    def apply_val_check_ge_train_batch(opt):
        """Clamp an integer val_check_interval to an integer
        limit_train_batches; 1 under fast_dev_run (reference
        options/base_options.py:249-265)."""
        if hasattr(opt, "val_check_interval"):
            if opt.fast_dev_run:
                opt.val_check_interval = 1
                return
            from shineon_tpu_torch.utils import str2num

            val_check_interval = str2num(opt.val_check_interval)
            limit_train_batches = str2num(opt.limit_train_batches)
            if (isinstance(val_check_interval, int) and isinstance(limit_train_batches, int)
                    and val_check_interval > limit_train_batches):
                opt.val_check_interval = opt.limit_train_batches


def namespace_from_defaults(model: str, dataset: str, is_train: bool = True, **overrides):
    """The namespace the command line gives for ``--model model --dataset
    dataset --name test`` and ``overrides`` (``key=value`` as ``--key
    value``; a True bool as ``--key``, a False one left out; a list as its
    items)."""
    from shineon_tpu_torch.options.test_options import TestOptions
    from shineon_tpu_torch.options.train_options import TrainOptions

    argv = ["--model", model, "--dataset", dataset, "--name", "test"]
    for key, value in overrides.items():
        if isinstance(value, bool):
            if value:
                argv.append(f"--{key}")
            continue
        argv.append(f"--{key}")
        if isinstance(value, (list, tuple)):
            argv.extend(str(v) for v in value)
        else:
            argv.append(str(value))
    options_obj = TrainOptions() if is_train else TestOptions()
    return options_obj.parse(argv)
