"""The train-step ablation tool (shineon_tpu_torch/tools/train_ablate.py)
on the CPU: each config's options and step at the JAX package's tiny
training configuration, and one f32 exact step with one multiscale
discriminator scale (num_D=1, a discriminator depth no other test holds)
against the JAX make_train_step, with test_torch_training_step.py's
tolerances (test_torch_training.assert_step_matches)."""

import jax  # noqa: F401 (JAX on the CPU before the JAX package)
import pytest
import torch

from shineon_tpu_torch.networks.vgg import Vgg19Features
from shineon_tpu_torch.tools import train_ablate
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import TINY_TRAIN, JaxSide, assert_step_matches


def test_configs_are_the_jax_tools():
    """The JAX tool's five configs, with its overrides."""
    assert train_ablate.CONFIGS == {"exact": {}, "fast": {"fast_gan_step": True},
                                    "no_vgg": {"wt_vgg": 0.0}, "f32_vgg": {},
                                    "num_D_1": {"num_D": 1}}
    with pytest.raises(ValueError, match="unknown config"):
        train_ablate.build_config("num_D_3", 1, "cpu", **TINY_TRAIN)


@pytest.mark.parametrize("name", list(train_ablate.CONFIGS))
def test_each_config_builds_its_options(name):
    """Each config's model: the options it sets, the others the exact
    step's; f32_vgg's perceptual loss an f32 VGG19 with the built model's
    filters, the step rebuilt over it."""
    tiny = {**TINY_TRAIN, "precision": 16}
    model, state, step, raw, n_frames = train_ablate.build_config(name, 1, "cpu", **tiny)
    opt = model.opt
    assert opt.fast_gan_step == (name == "fast") and opt.remat
    assert opt.wt_vgg == (0.0 if name == "no_vgg" else 1.0)
    assert opt.num_D == model.multiscale_discriminator.num_D == (1 if name == "num_D_1" else 2)
    vgg = model.criterion_vgg.model
    assert isinstance(vgg, Vgg19Features)
    assert vgg.convs[0].dtype == (None if name == "f32_vgg" else torch.bfloat16)
    if name == "f32_vgg":
        ref = train_ablate.build_config("exact", 1, "cpu", **tiny)[0].criterion_vgg.model
        for a, b in zip(vgg.state_dict().values(), ref.state_dict().values()):
            assert torch.equal(a, b)
    assert n_frames == 3 and callable(step)


def test_measure_config_runs_a_window_on_the_cpu():
    """measure_config on explicit CPU tensors: a window of one step after
    the warm-up, finite losses, the VGG term 0 with no_vgg."""
    r = train_ablate.measure_config("no_vgg", 1, "cpu", steps=1, repeats=1, **TINY_TRAIN)
    assert r["config"] == "no_vgg" and r["step_s"] > 0 and r["peak_mem_gib"] is None
    assert r["step_s_min"] == r["step_s"] == r["step_s_max"]
    assert r["fps"] == pytest.approx(3 / r["step_s"])
    assert r["losses"]["loss/G/vgg"] == 0.0 and r["losses"]["loss"] > 0


def test_num_D_1_exact_step_matches_jax():
    """One f32 exact step with a single multiscale discriminator scale from
    the same state as the JAX step."""
    side = JaxSide(False, **train_ablate.CONFIGS["num_D_1"])
    new_state, jmetrics = side.step()
    model, state, raw = side.port()
    assert model.multiscale_discriminator.num_D == 1
    metrics = model.make_train_step()(state, raw)
    assert state.step == 1 and int(new_state.step) == 1
    assert_step_matches(side, new_state, jmetrics, model, metrics, exact=True)
