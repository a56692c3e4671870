"""The port's SAMS training step against the JAX package's on the CPU
(shineon_tpu/models/sams_model.py::_generator_losses and make_train_step):
the generator's loss and its gradient for every generator parameter, one
exact step and one ``fast_gan_step`` step, at the JAX package's own tiny
training configuration (32x24, 3-frame clips, widths 2^3..2^5, one middle
block, ndf 8, batch 2, f32, random VGG filters). Every network's weights
and statistics are made by the JAX package's ``init_state`` and carried
across with shineon_tpu_torch.convert; the raw batch is the same. The
helpers, and the step with attention blocks, are in
test_torch_training.py."""

import jax
import numpy as np
import pytest

from shineon_tpu_torch import convert
from shineon_tpu_torch.models.sams_model import gradients
from test_torch_networks import _np, one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import JaxSide, assert_metrics, assert_step_matches, state_dict_of

# a gradient tensor that moves by more than this share of its largest entry
# when the batch's samples swap places is f32 noise in both frameworks; see
# test_generator_loss_and_gradient_match_jax
NOISE = 1e-3


@pytest.fixture(scope="module")
def plain():
    return JaxSide(attention=False)


def test_generator_loss_and_gradient_match_jax(plain):
    """The generator's loss terms (within 1e-4) and its gradient for every
    generator parameter against jax.value_and_grad of the JAX
    _generator_losses: each tensor within 1e-4 of its largest |gradient|;
    the statistics the pass stores within 1e-4.

    A bias feeding a batch norm has an exact gradient of zero: each
    framework returns f32 cancellation noise there (up to about 1e-4). Such
    a tensor is found without the port: its JAX gradient moves by more
    than NOISE of itself when the batch's two samples swap places (the
    same function, its sums in another order). There the port's gradient
    is only required to be finite; every such tensor must be a bias.
    Without the previous-frame window detached at the generator's input
    the gradient flows back through every earlier frame's generator pass,
    and this test fails."""
    jm = plain.model
    params = plain.state.nets["generator"].params

    @jax.jit
    def grad_of(p, batch):
        feats = jm.features(batch)
        return jax.value_and_grad(
            lambda q: jm._generator_losses(q, plain.state, feats, train=True), has_aux=True)(p)

    (_, (jmetrics, jstats, *_)), jgrads = grad_of(params, plain.batch)
    _, jgrads_swapped = grad_of(params, {k: v[::-1] for k, v in plain.batch.items()})

    model, _, raw = plain.port()
    named = dict(model.generator.named_parameters())
    loss, metrics, *_ = model.generator_losses(model.features(raw))
    grads = dict(zip(named, (g.numpy() for g in gradients(loss, list(named.values())))))
    assert_metrics({k: v.detach() for k, v in metrics.items()}, jmetrics, 1e-4, 1e-4)
    ref = state_dict_of({"params": _np(jgrads)}, convert.GENERATOR_RENAMES)
    swapped = state_dict_of({"params": _np(jgrads_swapped)}, convert.GENERATOR_RENAMES)
    assert sorted(ref) == sorted(grads)
    noise = []
    for name, r in ref.items():
        scale = np.abs(r).max()
        assert np.isfinite(grads[name]).all(), name
        if np.abs(swapped[name] - r).max() > NOISE * scale:
            noise.append(name)
        else:
            err = np.abs(grads[name] - r).max()
            assert err <= 1e-4 * scale, (name, err, scale)
    assert all(n.endswith(".bias") for n in noise), noise
    assert len(noise) < len(ref) // 4, noise
    stats = state_dict_of(_np(jstats), convert.GENERATOR_RENAMES)
    mine = model.generator.state_dict()
    assert stats
    for name, r in stats.items():
        assert np.abs(mine[name].numpy() - r).max() <= 1e-4 * np.abs(r).max(), name


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast_gan_step"])
def test_train_step_matches_jax(plain, fast):
    """One training step from the same state against the JAX step
    (test_torch_training.assert_step_matches)."""
    new_state, jmetrics = plain.step(fast)
    model, state, raw = plain.port(fast_gan_step=fast)
    metrics = model.make_train_step()(state, raw)
    assert state.step == 1 and int(new_state.step) == 1
    assert_step_matches(plain, new_state, jmetrics, model, metrics, exact=not fast)
