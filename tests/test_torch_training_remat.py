"""The port's SAMS training step with remat against the same step without,
on the CPU at the JAX package's tiny training configuration, without and
with attention blocks (moved out of test_torch_training.py so that it
runs on a worker of its own)."""

import pytest
import torch

from shineon_tpu_torch.bench import build_train
from test_torch_training import TINY_TRAIN, _snapshot
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("attention", [False, True], ids=["plain", "attention"])
def test_remat_matches_no_remat(attention):
    """One exact step with remat (each frame's activations recomputed in
    the backward pass, on a snapshot of the buffers the frame saw) against
    the same step without: the same metrics, statistics (running stats,
    spectral u and sigma: equal, so the recompute wrote none of them) and
    parameters (within 1e-3 of the learning rate: the gradients may sum in
    another order). A recompute that ran on the live buffers would
    normalise with the already-updated u and store the statistics twice."""
    placement = dict(attention_middle_indices=("-1",), attention_decoder_indices=("0",))
    runs = []
    for remat in (False, True):
        model, state, step, raw, _ = build_train(
            2, device="cpu", seed=11, remat=remat, **TINY_TRAIN,
            **(placement if attention else {}))
        if attention:
            g = torch.Generator().manual_seed(12)
            with torch.no_grad():
                for name, p in model.generator.named_parameters():
                    if name.endswith("gamma"):
                        p.copy_(0.5 + 0.1 * torch.randn(p.shape, generator=g))
        metrics = step(state, raw)
        runs.append((metrics, _snapshot(model)))
    (m0, s0), (m1, s1) = runs
    for k in m0:
        assert float(m0[k]) == pytest.approx(float(m1[k]), rel=1e-6), k
    for net in s0:
        for name, a in s0[net].items():
            b = s1[net][name]
            if name.endswith(("running_mean", "running_var", ".u", ".sigma")):
                assert torch.equal(a, b), (net, name)
            else:
                assert (a - b).abs().max().item() <= 1e-3 * 1e-4, (net, name)
