"""Data-parallel training across processes, one device each (counterpart of
shineon_tpu/parallel/mesh.py's ``make_mesh`` and ``shard_batch``; the
reference's Lightning DDP and SynchronizedBatchNorm):

    torchrun --nproc_per_node N -m shineon_tpu_torch.train \
        --distributed_backend ddp ...

The JAX package shards the global batch over a "data" mesh axis and lets
XLA insert the gradient all-reduce and the global batch-norm statistics.
Here each rank is a process with its own device (``cuda:LOCAL_RANK``, or
the CPU under ``--gpu_ids -1``) and the same seeded initial state:

  * :func:`setup` joins the process group (NCCL on a card, gloo on the
    CPU) from torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` or from an
    explicit ``init_method``;
  * each rank's loader strides the shuffled index space by rank and world
    size (``DataLoader(process_index=rank(), process_count=world_size())``)
    and loads ``batch_size`` samples, so the global batch is ``batch_size x
    world_size``, the one ``shard_batch`` assembles;
  * :func:`average_gradients` all-reduces each optimizer's gradients to
    their mean over the ranks before its update. The steps take gradients
    with ``torch.autograd.grad``, so DistributedDataParallel's reducer,
    which hooks ``.grad``, would never fire;
  * :func:`global_means` makes SyncBatchNorm's training statistics those of
    the global batch: the per-rank sums are all-reduced with autograd's
    all-reduce, whose backward all-reduces the gradient, so each rank's
    inputs receive the gradient of every rank's loss through the shared
    mean and variance.

With no process group, or a group of one, the statistics are the local
ones, computed as before, and the mean of one rank's gradients is those
gradients: world size 1 is the bare step exactly.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist


def launched(opt) -> bool:
    """Whether this process was started by torchrun (or another launcher
    that sets ``WORLD_SIZE``) to train with ``--distributed_backend ddp``."""
    return getattr(opt, "distributed_backend", "") == "ddp" and "WORLD_SIZE" in os.environ


def setup(device: torch.device, init_method: str = "env://", rank: int | None = None,
          world: int | None = None) -> torch.device:
    """Join the process group; returns this rank's device: ``cuda:LOCAL_RANK``
    for a CUDA ``device``, else the CPU. ``rank`` and ``world`` default to
    the launcher's ``RANK`` and ``WORLD_SIZE``."""
    rank = int(os.environ["RANK"]) if rank is None else rank
    world = int(os.environ["WORLD_SIZE"]) if world is None else world
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return device


def teardown() -> None:
    if active():
        dist.destroy_process_group()


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def average_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each rank's ``grads`` (one all-reduce of
    them flattened into one buffer); ``grads`` as they are without a
    process group."""
    grads = list(grads)
    if not active() or not grads:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world_size())
    return [g.view_as(p) for g, p in zip(flat.split([p.numel() for p in grads]), grads)]


def global_means(x: torch.Tensor, axes: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """E[x] and E[x^2] over ``axes`` of the global batch (every rank's
    ``x`` has the same shape), differentiable: autograd's all-reduce of the
    per-rank sums."""
    count = world_size() * x.numel() // x.shape[-1]
    sums = _AllReduceSum.apply(torch.cat([x.sum(dim=axes), (x * x).sum(dim=axes)]))
    return (sums / count).chunk(2)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum over the ranks of the
    gradients, since every rank's loss reads the sum."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def mean_scalars(values: Dict[str, float]) -> Dict[str, float]:
    """Each value's mean over the ranks (every rank passes the same keys)."""
    if not active() or not values:
        return values
    keys = sorted(values)
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([values[k] for k in keys], dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return dict(zip(keys, (t / world_size()).tolist()))


@torch.no_grad()
def broadcast_state(state) -> None:
    """Every tensor of a train state (modules' parameters and buffers, the
    optimizers' moments) from rank 0 to the others, as
    DistributedDataParallel does when it wraps a module."""
    if not active():
        return
    for net in state.nets.values():
        for t in list(net.module.state_dict().values()) + net.optimizer.tensors():
            dist.broadcast(t, src=0)
