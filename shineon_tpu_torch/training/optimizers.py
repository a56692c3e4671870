"""Adam with the reference's keep/decay learning-rate schedule (counterpart
of shineon_tpu/training/optimizers.py; reference models/base_model.py:165-184).

The schedule is a pure function of the step, and :class:`Adam` computes
``optax.adam(learning_rate=schedule)`` step for step: b1 0.9, b2 0.999, eps
1e-8, the moments updated as ``(1 - b) g + b m``, both bias-corrected, and
the learning rate read from the schedule at the count before this update.
With ``--accumulated_batches k > 1``, :class:`MultiSteps` wraps it as
``optax.MultiSteps(adam, every_k_schedule=k)`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Sequence

import torch


@dataclasses.dataclass
class KeepDecaySchedule:
    """lr(step): ``base_lr`` for ``keep_epochs`` epochs, then a linear decay
    1 - (epoch - keep_epochs) / (decay_epochs + 1), epoch = step //
    steps_per_epoch. A resumed fit sets ``steps_per_epoch`` to its loader's,
    as the JAX Trainer rebuilds its model's optimizer for it."""

    base_lr: float
    keep_epochs: int
    decay_epochs: int
    steps_per_epoch: int

    def __call__(self, step: int) -> float:
        epoch = step // max(self.steps_per_epoch, 1)
        return self.base_lr * (1.0 - max(0, epoch - self.keep_epochs)
                               / float(self.decay_epochs + 1))


def keep_decay_schedule(base_lr: float, keep_epochs: int, decay_epochs: int,
                        steps_per_epoch: int) -> KeepDecaySchedule:
    return KeepDecaySchedule(base_lr, keep_epochs, decay_epochs, steps_per_epoch)


class Adam:
    """optax's Adam over ``params`` (tensors updated in place by
    :meth:`step`); ``count`` is optax's update count."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        lr = self.schedule(self.count)
        self.count += 1
        grads = list(grads)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        # optax's bias corrections, in f32
        c1 = float(1.0 - torch.tensor(b1) ** self.count)
        c2 = float(1.0 - torch.tensor(b2) ** self.count)
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(updates, denom)
        torch._foreach_add_(self.params, updates, alpha=-lr)

    def versions(self) -> List[int]:
        """The version counter of every state tensor, and the count: any
        update moves one."""
        return [t._version for t in self.mu + self.nu] + [self.count]

    def tensors(self) -> List[torch.Tensor]:
        """The state tensors, on the parameters' device."""
        return self.mu + self.nu

    def state_dict(self) -> dict:
        """The moments (host copies, taken now) and the update count; the
        schedule is the caller's, as optax keeps it out of its state."""
        return {"mu": _host(self.mu), "nu": _host(self.nu), "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy the moments into this optimizer's tensors (on their device)."""
        if "acc" in state:
            raise ValueError("the saved optimizer accumulates gradients (--accumulated_batches "
                             "> 1); this one does not")
        for name in ("mu", "nu"):
            _copy_into(getattr(self, name), state[name], name)
        self.count = int(state["count"])


class MultiSteps:
    """``optax.MultiSteps(adam, every_k_schedule=k)``: each :meth:`step`
    takes one mini-step's gradients into their running mean (``acc + (g -
    acc) / (n + 1)``, n the mini-steps taken since the last update); the
    k-th hands the mean to the inner :class:`Adam`, which updates the
    parameters and counts one update (its schedule reads that count), and
    the mean restarts at zero. The other mini-steps leave the parameters and
    the moments as they are. The running mean and the mini-step count are
    part of the state, so a checkpoint taken between updates resumes
    exactly."""

    def __init__(self, inner: Adam, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be at least 1, got {every_k}")
        self.inner, self.every_k = inner, every_k
        self.params = inner.params
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0

    @property
    def schedule(self):
        return self.inner.schedule

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        delta = torch._foreach_sub(list(grads), self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        if self.mini_step == self.every_k - 1:
            self.inner.step(self.acc)
            torch._foreach_zero_(self.acc)
            self.mini_step = 0
        else:
            self.mini_step += 1

    def versions(self) -> List[int]:
        return self.inner.versions() + [t._version for t in self.acc] + [self.mini_step]

    def tensors(self) -> List[torch.Tensor]:
        return self.inner.tensors() + self.acc

    def state_dict(self) -> dict:
        """The inner Adam's state, the running mean and the mini-step count."""
        return {**self.inner.state_dict(), "acc": _host(self.acc), "mini_step": self.mini_step}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if "acc" not in state:
            raise ValueError("the saved optimizer does not accumulate gradients; this one "
                             f"accumulates {self.every_k} mini-steps")
        self.inner.load_state_dict({k: state[k] for k in ("mu", "nu", "count")})
        _copy_into(self.acc, state["acc"], "acc")
        self.mini_step = int(state["mini_step"])


def _host(tensors) -> list:
    """Host copies, taken now."""
    return [t.detach().to("cpu", copy=True) for t in tensors]


def _copy_into(mine, saved, name: str) -> None:
    if len(saved) != len(mine) or any(a.shape != b.shape for a, b in zip(mine, saved)):
        raise ValueError(f"the saved {name} does not fit this optimizer's parameters")
    for a, b in zip(mine, saved):
        a.copy_(b)


def make_optimizer(params: Iterable[torch.Tensor], lr: float, keep_epochs: int = 5,
                   decay_epochs: int = 5, steps_per_epoch: int = 1, accumulate: int = 1):
    """Adam on the keep/decay schedule, accumulating ``accumulate``
    mini-steps' gradients an update when that is more than 1."""
    adam = Adam(params, keep_decay_schedule(lr, keep_epochs, decay_epochs, steps_per_epoch))
    return MultiSteps(adam, accumulate) if accumulate > 1 else adam
