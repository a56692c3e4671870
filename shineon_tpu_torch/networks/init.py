"""Weight initialisation with the JAX package's rules, from an explicit
``torch.Generator`` (counterpart of shineon_tpu/networks/init.py).

The two frameworks draw different numbers from the same seed, so parity
tests carry weights across with :mod:`shineon_tpu_torch.convert`; these
initialisers only reproduce the distributions.
"""

from __future__ import annotations

import math

import torch

# flax lecun_normal: a normal truncated to +-2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def _fan_in(weight: torch.Tensor) -> int:
    """fan_in of an OIHW conv weight or an (out, in) linear weight."""
    return weight.shape[1] * (weight[0][0].numel() if weight.dim() > 2 else 1)


@torch.no_grad()
def truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator):
    """N(0, std) truncated to [-2 std, 2 std] by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
    u = lo + (1.0 - 2.0 * lo) * u
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    t.copy_((z * std).to(t.dtype))
    return t


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator: torch.Generator):
    """flax ``nn.initializers.lecun_normal()``: truncated normal with
    variance 1/fan_in."""
    std = math.sqrt(1.0 / _fan_in(weight)) / _TRUNC_STD
    return truncated_normal_(weight, std, generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator, mean: float = 0.0):
    """N(mean, std), the CP-VTON rule for GMM weights (std 0.02) and
    batch-norm scales (mean 1, std 0.02)."""
    t.copy_(mean + std * torch.randn(t.shape, generator=generator, dtype=t.dtype))
    return t
