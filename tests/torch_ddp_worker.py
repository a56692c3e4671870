"""Worker of tests/test_torch_ddp.py: one rank of a gloo process group on
the CPU (``world`` 0: no group) takes its share of a seeded global batch
of 4 and saves what it computed:

    python tests/torch_ddp_worker.py {sams,norm} RANK WORLD INIT_METHOD OUT

``sams``: a tiny SAMS exact step through shineon_tpu_torch.parallel.ddp,
its metrics and post-step state; ``norm``: a dense layer and a
train-mode SyncBatchNorm, the gradients of a loss through the global
statistics for the parameters (averaged over the ranks, as the optimizers
take them) and for this rank's inputs, and the running statistics.
Imports torch and the port only, so that a rank starts in seconds."""

from __future__ import annotations

import sys

import torch


def tiny_sams(batch: int):
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.options import sams_options
    from shineon_tpu_torch.serving import synthetic_raw_batch

    opt = sams_options(batch_size=batch, is_train=True, fine_height=32, fine_width=24,
                       n_frames_total=3, n_frames_now=3, ngf_pow_outer=3, ngf_pow_inner=5,
                       num_middle=1, ndf=8, precision=32)
    model = SamsModel(opt, device="cpu")
    state = model.init_state(torch.Generator().manual_seed(420), 10)
    return model, state, synthetic_raw_batch(opt, 4, seed=3)


def snapshot(state) -> dict:
    out = {"step": state.step}
    for name, net in state.nets.items():
        out.update({f"{name}.{k}": v.clone() for k, v in net.module.state_dict().items()})
        out.update({f"{name}.mu.{i}": t.clone() for i, t in enumerate(net.optimizer.mu)})
        out.update({f"{name}.nu.{i}": t.clone() for i, t in enumerate(net.optimizer.nu)})
    return out


def sams_step(rank: int, local: int) -> dict:
    model, state, raw = tiny_sams(local)
    raw = {k: v[rank * local:(rank + 1) * local].clone() for k, v in raw.items()}
    metrics = {k: float(v) for k, v in model.make_train_step()(state, raw).items()}
    return {"metrics": metrics, "state": snapshot(state)}


def norm_gradients(rank: int, local: int) -> dict:
    from shineon_tpu_torch.networks.normalization import SyncBatchNorm
    from shineon_tpu_torch.parallel import ddp

    g = torch.Generator().manual_seed(0)
    x = (torch.randn(4, 6, 5, 3, generator=g) * 2 + 1)[rank * local:(rank + 1) * local]
    target = torch.randn(4, 6, 5, 4, generator=g)[rank * local:(rank + 1) * local]
    dense = torch.nn.Linear(3, 4)
    with torch.no_grad():
        dense.weight.copy_(torch.randn(4, 3, generator=g))
        dense.bias.copy_(torch.randn(4, generator=g))
    norm = SyncBatchNorm(4)
    x.requires_grad_(True)
    y = norm(dense(x), use_running_average=False)
    loss = ((y - target) ** 2 * torch.linspace(0.5, 2.0, 4)).mean()
    params = [dense.weight, dense.bias, norm.weight, norm.bias]
    # one backward (its all-reduces run once on every rank); the parameters'
    # gradients averaged as the optimizers take them, the inputs' this rank's
    *grads, x_grad = torch.autograd.grad(loss, params + [x])
    grads = ddp.average_gradients(grads) + [x_grad]
    return {"grads": [t.detach() for t in grads], "loss": float(loss.detach()),
            "stats": [norm.running_mean.clone(), norm.running_var.clone()]}


def run(kind: str, rank: int, world: int, init_method: str, out: str) -> None:
    """``kind`` on samples [rank * 4 // world, (rank + 1) * 4 // world) of
    the global batch of 4, in a group of ``world`` (0: no group at all)."""
    from shineon_tpu_torch.parallel import ddp

    torch.set_num_threads(1)
    if world:
        ddp.setup(torch.device("cpu"), init_method, rank, world)
    try:
        local = 4 // max(world, 1)
        torch.save((sams_step if kind == "sams" else norm_gradients)(rank, local), out)
    finally:
        ddp.teardown()


if __name__ == "__main__":
    kind_, rank_, world_, init_, out_ = sys.argv[1:]
    run(kind_, int(rank_), int(world_), init_, out_)
