"""The port's command line (shineon_tpu_torch.options: the three-phase
parse, the model, network and dataset option setters) against the JAX
package's on the CPU: one counterpart of each test in tests/test_options.py,
and the parsed namespace key for key against the JAX parser's on the same
argv, for each model, dataset and phase and for every documented command.

Keys that differ by design (BY_DESIGN) are the only ones left out."""

import os

import pytest

from shineon_tpu.options.test_options import TestOptions as JTestOptions
from shineon_tpu.options.train_options import TrainOptions as JTrainOptions
from shineon_tpu_torch.options import TestOptions, TrainOptions, namespace_from_defaults

BY_DESIGN = {
    # JAX only: explicit --gpu_ids restrict the JAX Trainer's data mesh; the
    # port runs on one device, the first id (shineon_tpu_torch/train.py)
    "gpu_ids_explicit": "jax",
    # port test options only: the JAX package reads the int8 conv gate's
    # channel floor from SHINEON_INT8_MIN_CH; the port reads no environment
    # variable for int8 serving (as for --int8_spade)
    "int8_min_channels": "port-test",
}
MODELS = ("sams", "warp", "unet_mask")
DATASETS = ("viton", "vvt", "mpv", "viton_vvt_mpv")
# every command of README.md, docs/2_inference.md and docs/3_train.md
# (train.py or test.py, then its arguments), as a user types it
DOCUMENTED = [
    ("train", "--model warp --dataset viton --viton_dataroot /data/viton --name gmm_run"),
    ("train", "--model unet_mask --dataset viton --viton_dataroot /data/viton --name tom_run"),
    ("train", "--model sams --dataset vvt --vvt_dataroot /data/fw_gan_vvt --name sams_run "
              "--flow_warp"),
    ("test", "--model warp --dataset viton --checkpoint ckpt_dir --name gmm_run"),
    ("test", "--model warp --dataset vvt --vvt_dataroot data/fw_gan_vvt --checkpoint "
             "experiments/gmm_run/checkpoints/named/FINAL_step=100 --name gmm_run "
             "--datamode test"),
    ("test", "--model unet_mask --dataset vvt --vvt_dataroot data/fw_gan_vvt --warp_cloth_dir "
             "test_results/gmm_run/ckpt/test/VVTDataset/warp-cloth --checkpoint "
             "experiments/tom_run/checkpoints/named/FINAL_step=100 --name tom_run "
             "--datamode test"),
    ("test", "--model warp --dataset vvt --tryon_list pairs.csv"),
    ("test", "--model warp --datamode train"),
    ("test", "--model warp --checkpoint converted/gmm"),
    ("train", "--name gmm_train --model warp --dataset viton --viton_dataroot data "
              "--batch_size 8 --workers 4"),
    ("train", "--name tom_train --model unet_mask --dataset viton --viton_dataroot data "
              "--self_attn --num_attn 3 --activation swish"),
    ("train", "--name sams_train --model sams --dataset vvt --vvt_dataroot data/fw_gan_vvt "
              "--flow_warp --n_frames_total 5 --n_frames_now 3 --batch_size 4 "
              "--accumulated_batches 16 --checkpoint "
              "experiments/sams_train/checkpoints/named/FINAL_step=100"),
]


def parse_both(argv, train):
    """(JAX namespace, port namespace) of ``argv``, the by-design keys
    checked and left out."""
    jax_ns = vars((JTrainOptions() if train else JTestOptions()).parse(list(argv)))
    port_ns = vars((TrainOptions() if train else TestOptions()).parse(list(argv)))
    assert "gpu_ids_explicit" in jax_ns and "gpu_ids_explicit" not in port_ns
    assert ("int8_min_channels" in port_ns) == (not train)
    assert "int8_min_channels" not in jax_ns
    for key in BY_DESIGN:
        jax_ns.pop(key, None)
        port_ns.pop(key, None)
    return jax_ns, port_ns


@pytest.fixture(autouse=True)
def no_int8_env(monkeypatch):
    """The JAX parser writes SHINEON_INT8_SPADE under --int8_spade."""
    monkeypatch.delenv("SHINEON_INT8_SPADE", raising=False)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("model", MODELS)
def test_namespace_matches_jax(model, dataset, train):
    """The default namespace of each model, dataset and phase equals the
    JAX parser's key for key, values and types alike."""
    argv = ["--model", model, "--dataset", dataset, "--name", "test"]
    jax_ns, port_ns = parse_both(argv, train)
    assert port_ns == jax_ns
    assert {k: type(v) for k, v in port_ns.items()} == {k: type(v) for k, v in jax_ns.items()}


@pytest.mark.parametrize("phase,args", DOCUMENTED, ids=[f"{p}-{i}" for i, (p, _) in
                                                         enumerate(DOCUMENTED)])
def test_documented_commands_parse_as_jax(phase, args):
    jax_ns, port_ns = parse_both(args.split(), phase == "train")
    assert port_ns == jax_ns


# ---------------------------- counterparts of tests/test_options.py

def test_warp_viton_defaults():
    opt = namespace_from_defaults("warp", "viton")
    assert opt.model == "warp"
    assert opt.person_inputs == ["agnostic", "cocopose"]  # sorted
    assert opt.cloth_inputs == ["cloth"]
    assert opt.grid_size == 5
    assert opt.fine_width == 192 and opt.fine_height == 256
    assert opt.batch_size == 8
    assert opt.lr == 1e-4
    assert opt.keep_epochs == 5 and opt.decay_epochs == 5
    assert opt.precision == 16
    # image dataset: the n-frames flags are only injected by video datasets
    assert not hasattr(opt, "n_frames_total")


def test_model_synonyms():
    assert namespace_from_defaults("gmm", "viton").model == "warp"
    assert namespace_from_defaults("tom", "viton").model == "unet_mask"
    assert namespace_from_defaults("unet", "viton").model == "unet_mask"


def test_unet_mask_defaults():
    opt = namespace_from_defaults("unet_mask", "vvt")
    assert opt.person_inputs == ["agnostic", "densepose"]
    assert opt.pen_flow_mask == 1.0
    assert opt.n_frames_total == 1  # vvt injects the flag; default is 1
    assert opt.n_frames_now == 1  # defaulted to total


def test_sams_defaults():
    """As the JAX parser: SamsModel's set_defaults(n_frames_total=5) comes
    before the dataset phase adds --n_frames_total with its own default of
    1, which wins (the documented command passes --n_frames_total 5)."""
    opt = namespace_from_defaults("sams", "vvt")
    assert opt.person_inputs == ["agnostic", "densepose", "flow"]
    assert opt.encoder_input == "flow"
    assert opt.n_frames_total == 1
    assert opt.n_frames_now == 1
    assert opt.batch_size == 4  # SAMS overrides the base default of 8
    assert opt.norm_G == "spectralspadesyncbatch3x3"
    assert opt.ngf_base == 2 and opt.ngf_pow_outer == 6 and opt.ngf_pow_inner == 10
    assert opt.num_middle == 3
    assert opt.gan_mode == "hinge"
    assert opt.lr_D == 3e-4
    assert opt.num_D == 2 and opt.n_layers_D == 4 and opt.ndf == 64
    assert opt.norm_D == "spectralinstance"
    assert opt.wt_l1 == opt.wt_vgg == opt.wt_multiscale == opt.wt_temporal == 1.0
    assert opt.init_type == "xavier" and opt.init_variance == 0.02


def test_dataset_flags_injected():
    opt = namespace_from_defaults("warp", "vvt")
    assert hasattr(opt, "vvt_dataroot")
    assert hasattr(opt, "warp_cloth_dir")
    opt = namespace_from_defaults("warp", "viton")
    assert hasattr(opt, "viton_dataroot") and opt.data_list == "train_pairs.txt"
    opt = namespace_from_defaults("warp", "mpv")
    assert hasattr(opt, "mpv_dataroot")
    opt = namespace_from_defaults("warp", "viton_vvt_mpv")
    assert hasattr(opt, "viton_dataroot")
    assert hasattr(opt, "vvt_dataroot")
    assert hasattr(opt, "mpv_dataroot")


def test_test_options():
    opt = namespace_from_defaults("warp", "viton", is_train=False)
    assert opt.is_train is False
    assert opt.datamode == "test"
    assert opt.no_shuffle is True
    assert opt.result_dir == "test_results"
    assert opt.val_fraction == 0  # whole set at test time


def test_n_frames_now_override():
    opt = namespace_from_defaults("sams", "vvt", n_frames_total=5, n_frames_now=2)
    assert opt.n_frames_now == 2 and opt.n_frames_total == 5


def test_val_check_clamped_to_datacap():
    opt = namespace_from_defaults("warp", "viton", val_check_interval="100", datacap="10")
    assert opt.val_check_interval == "10"


def test_fast_dev_run_forces_val_every_step():
    opt = namespace_from_defaults("warp", "viton", fast_dev_run=True)
    assert opt.val_check_interval == 1


def test_test_without_checkpoint_refuses():
    """The test entry without --checkpoint fails loudly (reference
    train.py:39-45) unless --allow_random_init, before it builds anything."""
    from shineon_tpu_torch import train

    argv = ["--name", "guard_test", "--model", "warp", "--dataset", "viton",
            "--viton_dataroot", "/nonexistent", "--gpu_ids", "-1"]
    with pytest.raises(SystemExit, match="checkpoint"):
        train.main(train=False, argv=argv)
    opt = namespace_from_defaults("warp", "viton", is_train=False)
    assert opt.allow_random_init is False


def test_int8_spade_is_an_option():
    """--int8_spade (test options) is an option of the namespace only: the
    port's parse sets no environment variable (the JAX parser sets
    SHINEON_INT8_SPADE), and the int8 conv gate's floor is an option too."""
    opt = TestOptions().parse(argv=[
        "--name", "int8_opt", "--model", "warp", "--dataset", "viton",
        "--viton_dataroot", "/nonexistent", "--int8_spade", "--int8_min_channels", "256",
    ])
    assert opt.int8_spade is True and opt.int8_min_channels == 256
    assert "SHINEON_INT8_SPADE" not in os.environ


def test_int8_spade_does_not_leak_across_parses(monkeypatch):
    """A parse without --int8_spade gives int8_spade False after one with
    it, and an exported SHINEON_INT8_SPADE neither turns it on nor is
    touched."""
    base = ["--name", "int8_leak", "--model", "warp", "--dataset", "viton",
            "--viton_dataroot", "/nonexistent"]
    assert TestOptions().parse(argv=base + ["--int8_spade"]).int8_spade is True
    assert TestOptions().parse(argv=base).int8_spade is False
    monkeypatch.setenv("SHINEON_INT8_SPADE", "1")
    assert TestOptions().parse(argv=base).int8_spade is False
    assert os.environ.get("SHINEON_INT8_SPADE") == "1"


def test_exact_gan_step_is_default():
    opt = namespace_from_defaults("sams", "vvt")
    assert opt.fast_gan_step is False
    assert namespace_from_defaults("sams", "vvt", fast_gan_step=True).fast_gan_step is True
