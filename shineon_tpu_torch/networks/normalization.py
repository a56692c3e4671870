"""Normalization layers (counterpart of shineon_tpu/networks/normalization.py):
instance norm, flax-compatible (sync) batch norm and flax-exact spectral norm.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from shineon_tpu_torch.networks.layers import EvalCache, compute_dtype, conv2d_nhwc
from shineon_tpu_torch.ops.int8_conv import conv3x3_int8, quantize_weight
from shineon_tpu_torch.parallel import ddp


def instance_norm(x: torch.Tensor, eps: float = 1e-5, return_affine: bool = False,
                  dtype: Optional[torch.dtype] = None):
    """Per-sample, per-channel normalization over (H, W) with f32 statistics
    (torch InstanceNorm2d semantics, affine off). With ``return_affine`` it
    returns the folded per-(sample, channel) (a, b) with norm(x) = x*a + b."""
    xf = x.float()
    mean = xf.mean(dim=(-3, -2), keepdim=True)
    var = xf.var(dim=(-3, -2), keepdim=True, unbiased=False)
    a = torch.rsqrt(var + eps)
    if return_affine:
        return a.flatten(-3), (-mean * a).flatten(-3)
    return ((xf - mean) * a).to(dtype or x.dtype)


class SyncBatchNorm(nn.Module):
    """Batch norm over every axis but the last, with flax BatchNorm's
    numerics: eps 1e-5, biased variance E[x^2] - E[x]^2, running update
    ``ra = 0.9 ra + 0.1 batch`` (momentum 0.9), and the affine-folded output
    ``(x * a + b)`` cast to the output dtype. Under data parallelism the
    training statistics are the global batch's
    (:func:`shineon_tpu_torch.parallel.ddp.global_means`); on one process
    the batch is the global batch."""

    def __init__(self, num_features: int, affine: bool = True, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor, use_running_average: bool,
                return_affine: bool = False):
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            if ddp.world_size() > 1:  # the global batch's, across the ranks
                mean, mean_sq = ddp.global_means(xf, axes)
            else:
                mean, mean_sq = xf.mean(dim=axes), (xf * xf).mean(dim=axes)
            var = mean_sq - mean * mean
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        a = torch.rsqrt(var + self.eps)
        b = -mean * a
        if self.weight is not None:
            a = a * self.weight
            b = b * self.weight + self.bias
        if return_affine:
            return a, b
        return (x * a + b).to(self.dtype or x.dtype)


def _l2_normalize(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v * torch.rsqrt((v * v).sum() + eps)


class SpectralConv2d(nn.Module):
    """NHWC conv whose kernel is spectrally normalized exactly as flax
    ``nn.SpectralNorm`` does it (not ``torch.nn.utils.spectral_norm``): the
    kernel viewed as a (kh*kw*cin, cout) matrix, ``u`` of shape (1, cout),
    one power step from the stored ``u`` at EVERY call (eval too), eps 1e-12,
    and ``u``/``sigma`` stored only when updating stats. At eval the step is
    deterministic, so the normalized kernel is computed once and reused
    until the weight or ``u`` changes. With ``int8`` (3x3 SAME only),
    ``forward(x, quantize=True)`` runs the int8 conv on the normalized
    kernel quantized from its f32 values, as flax ``SpectralNorm`` hands
    ``Int8Conv`` an f32 kernel. ``stride`` and ``padding`` are the conv's
    (the discriminators' k4 s2 pad-2 convs)."""

    def __init__(self, cin: int, cout: int, ksize: int, padding: int = 0,
                 bias: bool = True, dtype: Optional[torch.dtype] = None,
                 eps: float = 1e-12, int8: bool = False, stride: int = 1):
        super().__init__()
        if int8 and (ksize, padding, stride) != (3, 1, 1):
            raise ValueError("int8 takes 3x3 SAME convolutions only")
        self.stride, self.padding, self.dtype, self.eps, self.int8 = (
            stride, padding, dtype, eps, int8)
        self.weight = nn.Parameter(torch.empty(cout, cin, ksize, ksize))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer("u", torch.empty(1, cout))
        self.register_buffer("sigma", torch.ones(()))
        self._eval_cache = EvalCache()

    def normalized_weight(self, update_stats: bool) -> torch.Tensor:
        cout = self.weight.shape[0]
        value = self.weight.reshape(cout, -1).t()  # (K, cout); K order is immaterial
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ value.t(), self.eps)
            u0 = _l2_normalize(v0 @ value, self.eps)
        sigma = (v0 @ value @ u0.t())[0, 0]
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_stats: bool = False,
                quantize: bool = False) -> torch.Tensor:
        cd = compute_dtype(self.dtype)
        if quantize and self.int8:
            if update_stats:
                raise ValueError("the int8 conv serves eval only: no update_stats")
            qw = self._eval_cache.get(
                (self.weight, self.u), "int8",
                lambda: quantize_weight(self.normalized_weight(False)),
            )
            return conv3x3_int8(x, qw, self.bias, cd)
        if update_stats or torch.is_grad_enabled():
            w = self.normalized_weight(update_stats).to(cd)
        else:
            w = self._eval_cache.get(
                (self.weight, self.u), cd, lambda: self.normalized_weight(False).to(cd)
            )
        return conv2d_nhwc(x, w, self.bias, cd, self.stride, self.padding)
