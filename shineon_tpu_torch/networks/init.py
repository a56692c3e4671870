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


def _fans(weight: torch.Tensor):
    """fan_in, fan_out of an OIHW conv or (out, in) linear weight: the
    numbers the JAX package reads off the HWIO or (in, out) kernel."""
    receptive = weight[0][0].numel() if weight.dim() > 2 else 1
    return weight.shape[1] * receptive, weight.shape[0] * receptive


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
    std = math.sqrt(1.0 / _fans(weight)[0]) / _TRUNC_STD
    return truncated_normal_(weight, std, generator)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator, mean: float = 0.0):
    """N(mean, std), the CP-VTON rule for GMM weights (std 0.02) and
    batch-norm scales (mean 1, std 0.02)."""
    t.copy_(mean + std * torch.randn(t.shape, generator=generator, dtype=t.dtype))
    return t


@torch.no_grad()
def orthogonal_(weight: torch.Tensor, gain: float, generator: torch.Generator):
    """``jax.nn.initializers.orthogonal(scale=gain)`` on the JAX package's
    kernel layout: the HWIO (or (in, out)) kernel as a (kh*kw*cin, cout)
    matrix, rows in (kh, kw, cin) order; a normal draw of (max, min) of the
    two sides, its QR with the columns of Q signed by diag(R), transposed
    when the matrix is wide, times ``gain``. Its columns (its rows, if
    fewer) are orthonormal."""
    rows, cols = weight[0].numel(), weight.shape[0]  # kh*kw*cin (or in), cout (or out)
    z = torch.randn(max(rows, cols), min(rows, cols), generator=generator, dtype=torch.float64)
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r))
    if rows < cols:
        q = q.t()
    if weight.dim() > 2:  # (kh*kw*cin, cout) -> HWIO -> OIHW
        cout, cin, kh, kw = weight.shape
        q = q.reshape(kh, kw, cin, cout).permute(3, 2, 0, 1)
    else:  # (in, out) -> (out, in)
        q = q.t()
    weight.copy_((gain * q).to(weight.dtype))
    return weight


@torch.no_grad()
def kernel_init_(weight: torch.Tensor, init_type: str, gain: float,
                 generator: torch.Generator):
    """The JAX package's ``kernel_init_for(init_type, gain)`` (the reference's
    torch init of the same name):

    normal         N(0, gain)
    xavier         N(0, gain * sqrt(2 / (fan_in + fan_out)))
    xavier_uniform U(+-sqrt(6 / (fan_in + fan_out)))
    kaiming        N(0, sqrt(2 / fan_in))
    orthogonal     gain * Q, ``jax.nn.initializers.orthogonal(scale=gain)``
                   (:func:`orthogonal_`)
    none           lecun normal (flax's default)
    """
    fan_in, fan_out = _fans(weight)
    if init_type == "normal":
        return normal_(weight, gain, generator)
    if init_type == "xavier":
        return normal_(weight, gain * math.sqrt(2.0 / (fan_in + fan_out)), generator)
    if init_type == "xavier_uniform":
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand(weight.shape, generator=generator, dtype=weight.dtype)
        return weight.copy_((2.0 * u - 1.0) * lim)
    if init_type == "kaiming":
        return normal_(weight, math.sqrt(2.0 / fan_in), generator)
    if init_type == "orthogonal":
        return orthogonal_(weight, gain, generator)
    if init_type == "none":
        return lecun_normal_(weight, generator)
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")


@torch.no_grad()
def store_spectral_init(conv, generator: torch.Generator):
    """What flax's ``nn.SpectralNorm`` leaves in a fresh state, for a
    ``SpectralConv2d`` whose kernel was just drawn: its ``init`` runs the
    layer through ``map_variables(..., init=True, mutable=True)``, which
    writes the normalized kernel back into the parameters. So the stored
    kernel is W / sigma, sigma from ONE power step from ``u`` ~ N(0, 1) in
    the (kh*kw*cin, cout) view; ``u`` stays that draw and ``sigma`` 1 (the
    JAX package initializes with ``update_stats`` off)."""
    conv.u.copy_(torch.randn(conv.u.shape, generator=generator))
    conv.sigma.fill_(1.0)
    conv.weight.copy_(conv.normalized_weight(update_stats=False))
