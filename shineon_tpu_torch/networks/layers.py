"""NHWC convolution and dense layers with flax ``nn.Conv``/``nn.Dense``
semantics: parameters stay f32 and are cast, with the input, to the compute
dtype (``dtype``; None means f32) at every call. A conv built with
``int8=True`` runs the symmetric-int8 3x3 conv (``ops/int8_conv.py``, the
JAX package's ``Int8Conv``) when called with ``quantize=True`` (int8
serving); its parameters are the same, so its state_dict is unchanged."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shineon_tpu_torch.ops.int8_conv import conv3x3_int8, quantize_weight


def compute_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    """flax's ``dtype=None`` promotes the input with the f32 params."""
    return dtype or torch.float32


def conv2d_nhwc(x, weight, bias, dtype, stride=1, padding=0):
    """NHWC in and out; OIHW weight; computed in ``dtype``."""
    out = F.conv2d(
        x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype),
        None if bias is None else bias.to(dtype), stride=stride, padding=padding,
    )
    return out.permute(0, 2, 3, 1)


class Conv2d(nn.Module):
    """``nn.Conv`` over NHWC with explicit symmetric padding. With ``int8``
    (a 3x3 SAME conv only) ``forward(x, quantize=True)`` runs the int8 conv
    on the weight quantized from f32, cached while the weight is unchanged."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: Optional[torch.dtype] = None, int8: bool = False):
        super().__init__()
        if int8 and (ksize, stride, padding) != (3, 1, 1):
            raise ValueError("int8 takes 3x3 SAME convolutions only")
        self.stride, self.padding, self.dtype, self.int8 = stride, padding, dtype, int8
        self.weight = nn.Parameter(torch.empty(cout, cin, ksize, ksize))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self._int8_cache = EvalCache()

    def forward(self, x, quantize: bool = False):
        cd = compute_dtype(self.dtype)
        if quantize and self.int8:
            qw = self._int8_cache.get((self.weight,), "int8",
                                      lambda: quantize_weight(self.weight))
            return conv3x3_int8(x, qw, self.bias, cd)
        return conv2d_nhwc(x, self.weight, self.bias, cd, self.stride, self.padding)


class Dense(nn.Module):
    """``nn.Dense``: y = x W^T + b in the compute dtype."""

    def __init__(self, cin: int, cout: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        cd = compute_dtype(self.dtype)
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class EvalCache:
    """One value derived from some tensors, recomputed when any of them is
    replaced or modified in place (data pointer or version counter)."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, tensors, extra, fn):
        key = tuple((t.data_ptr(), t._version) for t in tensors) + (extra,)
        if key != self._key:
            self._value = fn()
            self._key = key
        return self._value
