"""The port's SAMS validation and visual steps against the JAX package's
(shineon_tpu/models/sams_model.py::make_val_step, make_visual_step) on
the CPU, f32, at the JAX package's own tiny training configuration
(test_torch_training.TINY_TRAIN: 32x24, 3-frame clips, widths 2^3..2^5,
one middle block, ndf 8, batch 2), without and with attention blocks
(every gamma nonzero). Every network's weights and statistics come from
the JAX package's ``init_state``, carried across with
shineon_tpu_torch.convert; the raw batch is the same."""

import numpy as np
import pytest
import torch

from test_torch_training import JaxSide
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "attention"])
def side(request):
    return JaxSide(attention=request.param)


def test_val_step_matches_jax(side):
    """The eval-mode objective: every metric (the adversarial terms of both
    discriminators, L1, VGG and checkpoint_on, which is L1 + VGG of the last
    frame with their weights) within 1e-4 of max(|ref|, 1); the step stores
    no statistics and moves no parameter."""
    jmetrics = side.model.make_val_step()(side.state, side.batch)
    model, state, raw = side.port()
    before = {n: {k: v.clone() for k, v in net.module.state_dict().items()}
              for n, net in state.nets.items()}
    metrics = model.make_val_step()(state, raw)
    assert sorted(metrics) == sorted(jmetrics) and "checkpoint_on" in metrics
    for k, r in jmetrics.items():
        r = float(r)
        assert abs(float(metrics[k]) - r) <= 1e-4 * max(abs(r), 1.0), (k, float(metrics[k]), r)
    assert float(metrics["checkpoint_on"]) == pytest.approx(
        float(metrics["loss/G/l1"]) + float(metrics["loss/G/vgg"]), rel=1e-6)
    for n, net in state.nets.items():
        after = net.module.state_dict()
        assert all(torch.equal(v, after[k]) for k, v in before[n].items()), n
    assert state.step == 0


def test_visual_step_matches_jax(side):
    """The eval-mode clip all_gen_frames (B, N, H, W, 3) and the inputs shown
    beside it, each within 1e-4 of its largest entry."""
    jvis = side.model.make_visual_step()(side.state, side.batch)
    model, state, raw = side.port()
    vis = model.make_visual_step()(state, raw)
    assert sorted(vis) == sorted(jvis)
    assert vis["all_gen_frames"].shape == (2, 3, 32, 24, 3)
    for k, r in jvis.items():
        r = np.asarray(r)
        assert tuple(vis[k].shape) == r.shape, k
        assert np.abs(vis[k].numpy() - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-6), k
