"""Selectable activations (counterpart of shineon_tpu/networks/activation.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sine(x):
    """SIREN activation sin(30 x)."""
    return torch.sin(30.0 * x)


def swish(x):
    return x * torch.sigmoid(x)


def leaky_relu(x, negative_slope: float = 0.01):
    """``jax.nn.leaky_relu``: x where x >= 0, else slope * x. Its derivative
    at 0 is 1, where torch's ``F.leaky_relu`` takes the slope; in training
    the port follows JAX (the first frame's all-zero window makes exact
    zeros common, and each one would scale a gradient by the slope). Outside
    autograd the values are the same, so the one-kernel torch op runs."""
    if torch.is_grad_enabled() and x.requires_grad:
        return torch.where(x >= 0, x, negative_slope * x)
    return F.leaky_relu(x, negative_slope)


def leaky_relu_02(x):
    return leaky_relu(x, 0.2)


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def get_activation_fn(activation: str):
    """relu/gelu/swish/sine switch."""
    table = {"relu": F.relu, "gelu": _gelu, "swish": swish, "sine": sine}
    if activation not in table:
        raise RuntimeError(
            f"activation must be one of relu/gelu/swish/sine; got {activation!r}"
        )
    return table[activation]


def get_resblock_activation_fn(activation: str):
    """AnySpadeResBlock maps 'relu' to LeakyReLU(0.2) (reference
    sams/spade.py:183-192)."""
    if activation == "relu":
        return leaky_relu_02
    return get_activation_fn(activation)
