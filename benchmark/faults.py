"""Faults a serving cell can have, planted under the timed path (tests) or
applied to a run's judged outputs (the readings on the card, which need no
second window): every hand-in answered with the first one's frames (the
clip's state never moves on); half of each batch left out, its frames
standing in for the rest; two users' clips swapped (an answer altered where
it is produced). One chip: no exchange between chips to leave out.

Two more are planted inside the port's SPADE chains while the timed call
runs (``PLANTED``; the card's readings take a window of their own):
``no_modulation``, each chain applying its folded norm alone, as a kernel
that left out the [gamma | beta] convs would (gamma = beta = 0); and
``hidden_scale`` (int8 configurations), each label's hidden map quantized
with a quarter of its abs-max as its range, as a pre-pass that got the
scale wrong would (values past it saturate)."""

from __future__ import annotations

import contextlib

import torch


def _half(out: torch.Tensor, B: int, n: int) -> torch.Tensor:
    return torch.cat([out, out[: B - n]], dim=0)


def _swap(out: torch.Tensor) -> torch.Tensor:
    out = out.clone()
    out[[0, -1]] = out[[-1, 0]]
    return out


def _norm_only(x, ab, segs, *args, **kwargs):
    C = x.shape[-1]
    out = x.float()
    for l in range(len(segs)):
        out = out * ab[:, l, :C].float()[:, None, None, :] + ab[:, l, C:].float()[:, None, None, :]
    return out.to(x.dtype)


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _chain_fault(name: str):
    """The patch that plants chain fault ``name`` in the port."""
    from shineon_tpu_torch.networks.sams import spade
    from shineon_tpu_torch.ops import fused_spade

    if name == "no_modulation":
        return _patched(spade, "fused_multispade_modulate", _norm_only)
    # hidden_scale: on the card the pre-pass's abs-max, on the CPU the plain
    # chain's int8 conv input, each a quarter of the true range
    absmax, conv = fused_spade.hidden_absmax, fused_spade.conv3x3_int8_plain

    def quarter_absmax(*args, **kwargs):
        return absmax(*args, **kwargs) / 4

    def clipped_conv(h, *args, **kwargs):
        top = h.abs().amax() / 4
        return conv(torch.clamp(h, -top, top), *args, **kwargs)

    stack = contextlib.ExitStack()
    stack.enter_context(_patched(fused_spade, "hidden_absmax", quarter_absmax))
    stack.enter_context(_patched(fused_spade, "conv3x3_int8_plain", clipped_conv))
    return stack


def plant(served, name: str):
    """Break ``served.one_clip`` by fault ``name``."""
    one_clip, first = served.one_clip, []

    if name in PLANTED:
        def chain(raw):
            with _chain_fault(name):
                return one_clip(raw)

        served.one_clip = chain
        return

    def stale(raw):
        if not first:
            first.append(one_clip(raw))
        return first[0]

    def half(raw):
        B = next(iter(raw.values())).shape[0]
        n = max(B // 2, 1)
        return _half(one_clip({k: v[:n] for k, v in raw.items()}), B, n)

    def swap(raw):
        return _swap(one_clip(raw))

    served.one_clip = {"stale": stale, "half_batch": half, "swapped": swap}[name]


def apply(name: str, outputs: dict, first: torch.Tensor) -> dict:
    """The judged outputs ({hand-in: frames}) as fault ``name`` would have
    left them; ``first`` the first hand-in's frames."""
    if name == "stale":
        return {i: first for i in outputs}
    if name == "half_batch":
        return {i: _half(o[: max(o.shape[0] // 2, 1)], o.shape[0], max(o.shape[0] // 2, 1))
                for i, o in outputs.items()}
    if name == "swapped":
        return {i: _swap(o) for i, o in outputs.items()}
    raise ValueError(name)


NAMES = ("stale", "half_batch", "swapped")
PLANTED = ("no_modulation", "hidden_scale")
