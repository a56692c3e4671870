"""Adam with the reference's keep/decay learning-rate schedule (counterpart
of shineon_tpu/training/optimizers.py; reference models/base_model.py:165-184).

The schedule is a pure function of the step, and :class:`Adam` computes
``optax.adam(learning_rate=schedule)`` step for step: b1 0.9, b2 0.999, eps
1e-8, the moments updated as ``(1 - b) g + b m``, both bias-corrected, and
the learning rate read from the schedule at the count before this update.
Gradient accumulation (``optax.MultiSteps``, ``--accumulated_batches``) is
not ported.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import torch


def keep_decay_schedule(base_lr: float, keep_epochs: int, decay_epochs: int,
                        steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step): ``base_lr`` for ``keep_epochs`` epochs, then a linear decay
    1 - (epoch - keep_epochs) / (decay_epochs + 1)."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * (1.0 - max(0, epoch - keep_epochs) / float(decay_epochs + 1))

    return schedule


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

    def state_dict(self) -> dict:
        """The moments (host copies, taken now) and the update count; the
        schedule is the caller's, as optax keeps it out of its state."""
        return {"mu": [m.detach().to("cpu", copy=True) for m in self.mu],
                "nu": [v.detach().to("cpu", copy=True) for v in self.nu],
                "count": self.count}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy the moments into this optimizer's tensors (on their device)."""
        for name in ("mu", "nu"):
            mine, saved = getattr(self, name), state[name]
            if len(saved) != len(mine) or any(a.shape != b.shape for a, b in zip(mine, saved)):
                raise ValueError(f"the saved {name} does not fit this optimizer's parameters")
            for a, b in zip(mine, saved):
                a.copy_(b)
        self.count = int(state["count"])


def make_optimizer(params: Iterable[torch.Tensor], lr: float, keep_epochs: int = 5,
                   decay_epochs: int = 5, steps_per_epoch: int = 1,
                   accumulate: int = 1) -> Adam:
    if accumulate > 1:
        raise NotImplementedError(
            "accumulated_batches > 1 (the JAX package's optax.MultiSteps) is not ported yet")
    return Adam(params, keep_decay_schedule(lr, keep_epochs, decay_epochs, steps_per_epoch))
