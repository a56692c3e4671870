"""The command line's options and the keyword builders.

The command line (``python -m shineon_tpu_torch.train`` and ``.test``)
parses with :class:`TrainOptions` and :class:`TestOptions`
(``base_options.py``: the three-phase parse of the JAX package's
``shineon_tpu/options``). The builders below make a namespace from keyword
arguments, without a parse:

The production options of the serving clip and the training step, a
local copy of the JAX package's ``__graft_entry__._sams_opt`` defaults (SAMS
at 256x192, 5-frame clips, flow warping, spectral SPADE sync-batch, widths
2^6..2^10, three middle blocks, bf16; two spectral-instance PatchGAN
discriminators, hinge loss, Adam at 1e-4 / 3e-4, the random-filter VGG
gate) and of the GMM's warp-stage overrides; and of the documented GMM and
TOM training configurations (docs/3_train.md). int8 serving is an option
(``int8_spade``) rather than an environment variable; so are the JAX
package's ``--remat``, ``--fast_gan_step`` and ``--reference_gan_semantics``
flags.

Every builder also carries the keys of the datasets and of the training
runtime, with the defaults the JAX package's parsers give them
(shineon_tpu/options/base_options.py, train_options.py, test_options.py
and each dataset's ``modify_commandline_options``); with ``is_train=False``
the test parser's defaults (``datamode`` "test", ``no_shuffle``,
``val_fraction`` 0). A builder clamps an integer ``val_check_interval`` to
an integer ``limit_train_batches``, and ``fast_dev_run`` sets it to 1
(base_options.py:249-265); an unset ``n_frames_now`` is
``n_frames_total``."""

from __future__ import annotations

import argparse

from shineon_tpu_torch.options import gan_options  # noqa: F401
from shineon_tpu_torch.options.base_options import (  # noqa: F401
    BaseOptions,
    namespace_from_defaults,
)
from shineon_tpu_torch.options.test_options import TestOptions  # noqa: F401
from shineon_tpu_torch.options.train_options import TrainOptions  # noqa: F401
from shineon_tpu_torch.utils import str2num

# the dataset keys (TryonDataset, VitonDataset, VVTDataset, MPVDataset) and
# the runtime keys (the base, train and test parsers) of the JAX package
_RUNTIME_DEFAULTS = dict(
    vvt_dataroot="/data_hdd/fw_gan_vvt", viton_dataroot="data",
    mpv_dataroot="/data_hdd/mpv_competition", data_list="train_pairs.txt", val_fraction=0.01,
    warp_cloth_dir=None, tryon_list=None, random_tryon=False,
    name="unnamed_experiment", experiments_dir="experiments", checkpoint="", workers=4,
    limit_train_batches="1.0", limit_val_batches="1.0", display_count=200, save_count=10000,
    val_check_interval="0.125", fast_dev_run=False, no_shuffle=False, result_dir="test_results",
)
# what the test parser sets instead (test_options.py:15-20, tryon_dataset.py:63-64)
_TEST_DEFAULTS = dict(datamode="test", no_shuffle=True, val_fraction=0)

_SAMS_DEFAULTS = dict(
    model="sams", dataset="vvt", datamode="train", is_train=True,
    person_inputs=["agnostic", "densepose", "flow"], cloth_inputs=["cloth"],
    fine_height=256, fine_width=192, radius=5, cloth_mask_threshold=240,
    visualize_flow=False, n_frames_total=5, n_frames_now=5, flow_warp=True,
    encoder_input="flow", activation="relu", norm_G="spectralspadesyncbatch3x3",
    ngf_base=2, ngf_pow_outer=6, ngf_pow_inner=10, ngf_pow_step=1, num_middle=3,
    attention_middle_indices=(), attention_decoder_indices=(), batch_size=4,
    ngf=64, precision=16, grid_size=5,
    # int8 serving (the JAX package's --int8_spade / SHINEON_INT8_SPADE=1,
    # which bench.py turns on for its timed clip) and its conv gate's
    # channel floor (SHINEON_INT8_MIN_CH); eval only, off here
    int8_spade=False, int8_min_channels=64,
    # training: the discriminators, losses and optimizers
    init_type="xavier", init_variance=0.02, num_D=2, ndf=64, n_layers_D=4,
    norm_D="spectralinstance", gan_mode="hinge", lr=1e-4, lr_D=3e-4,
    no_ganFeat_loss=False, wt_l1=1.0, wt_vgg=1.0, wt_multiscale=1.0, wt_temporal=1.0,
    keep_epochs=5, decay_epochs=5, accumulated_batches=1,
    # no pretrained VGG19 in the repository: the random-filter perceptual
    # loss, as the JAX package's dry runs and bench take it
    allow_random_vgg=True,
    # per-frame activation recompute; D updates on the G step's frames; the
    # reference's pred_real in the generator's adversarial terms
    remat=False, fast_gan_step=False, reference_gan_semantics=False,
)


# The attention serving clip's placement: the last middle block (16x12 at
# the production size, the JAX package's own generator test's placement)
# and decoder block 1 (64x48, 3072 tokens)
ATTENTION_PLACEMENT = dict(attention_middle_indices=("-1",), attention_decoder_indices=("1",))


def sams_options(**overrides) -> argparse.Namespace:
    """The SAMS generator's options; keyword arguments override defaults."""
    return _options(_SAMS_DEFAULTS, overrides)


def warp_options(**overrides) -> argparse.Namespace:
    """The GMM warp stage of the serving clip: agnostic + densepose person
    inputs, no flow warp, a 5x5 TPS grid."""
    base = dict(model="warp", person_inputs=["agnostic", "densepose"], flow_warp=False,
                grid_size=5)
    return sams_options(**{**base, **overrides})


# The GMM's training configuration (docs/3_train.md, "1. Warp"): `--model
# warp`, batch 8, 256x192, agnostic + cocopose person inputs (the warp
# model's defaults), a 5x5 TPS grid, ngf 64, bf16 compute with f32
# parameters, Adam at 1e-4 on the keep/decay schedule
_GMM_DEFAULTS = dict(
    model="warp", dataset="viton", datamode="train", is_train=True,
    person_inputs=["agnostic", "cocopose"], cloth_inputs=["cloth"],
    fine_height=256, fine_width=192, radius=5, cloth_mask_threshold=240,
    visualize_flow=False, n_frames_total=1, n_frames_now=None, flow_warp=False, batch_size=8,
    ngf=64, grid_size=5, precision=16,
    lr=1e-4, keep_epochs=5, decay_epochs=5, accumulated_batches=1,
)

# TOM's training configuration (docs/3_train.md, "2. Try-on"): `--model
# unet_mask --self_attn --num_attn 3 --activation swish`, batch 8, 256x192,
# one frame, agnostic + densepose person inputs, pen_flow_mask 1, bf16, the
# same Adam. Its U-Net width is not --ngf but int(64 (ln n_frames + 1)). No
# pretrained VGG19 in the repository: the random-filter perceptual loss
_TOM_DEFAULTS = dict(
    model="unet_mask", dataset="viton", datamode="train", is_train=True,
    person_inputs=["agnostic", "densepose"], cloth_inputs=["cloth"],
    fine_height=256, fine_width=192, radius=5, cloth_mask_threshold=240,
    visualize_flow=False, n_frames_total=1, n_frames_now=None, flow_warp=False, batch_size=8,
    self_attn=True, num_attn=3, activation="swish", pen_flow_mask=1.0, precision=16,
    lr=1e-4, keep_epochs=5, decay_epochs=5, accumulated_batches=1,
    allow_random_vgg=True,
)


def _options(defaults, overrides) -> argparse.Namespace:
    defaults = {**defaults, **_RUNTIME_DEFAULTS}
    unknown = set(overrides) - set(defaults)
    if unknown:
        raise ValueError(f"unknown options: {sorted(unknown)}")
    if overrides.get("is_train", defaults["is_train"]) is False:
        defaults.update(_TEST_DEFAULTS)
    opt = argparse.Namespace(**{**defaults, **overrides})
    if opt.n_frames_now is None:
        opt.n_frames_now = opt.n_frames_total
    if opt.fast_dev_run:
        opt.val_check_interval = 1
    elif (isinstance(str2num(opt.val_check_interval), int)
          and isinstance(str2num(opt.limit_train_batches), int)
          and str2num(opt.val_check_interval) > str2num(opt.limit_train_batches)):
        opt.val_check_interval = opt.limit_train_batches
    return opt


def gmm_options(**overrides) -> argparse.Namespace:
    """The GMM's training options; keyword arguments override defaults."""
    return _options(_GMM_DEFAULTS, overrides)


def tom_options(**overrides) -> argparse.Namespace:
    """TOM's training options; keyword arguments override defaults."""
    return _options(_TOM_DEFAULTS, overrides)
