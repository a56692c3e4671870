"""Symmetric-int8 3x3 SAME convolution (counterpart of the JAX package's
``shineon_tpu/networks/sams/spade.py::_conv_same_int8``, the numerics of
``Int8Conv``).

    s   = max |x| / 127 + 1e-30              one scale for the whole tensor
    q   = clip(round(x / s), -127, 127)      int8, round half to even
    acc = conv3x3(q, wq)                     exact integer sums
    y   = acc * (s * ksc) + bias             f32, then the compute dtype

with the weights quantized once per output channel from their f32 values
(:func:`quantize_weight`).

* :func:`conv3x3_int8_plain` is the plain PyTorch version. The integer sums
  (up to 127^2 * 9 * Cin, beyond f32's 2^24) are taken in float64, which is
  exact below 2^53, and rounded to f32 once, as int32 -> f32 is.
* :func:`conv3x3_int8` is the wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/int8_conv3x3.cu`` (which quantizes its input
  as it loads it) or raises; on a CPU tensor it computes the plain version.
  Each kernel launch adds one to ``conv3x3_int8.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

KERNEL_SOURCE = "int8_conv3x3"
CHANNEL_TILE = 64  # the kernel takes Cin and Cout in multiples of this

# Kernel against plain version, elementwise: |kernel - plain| <= tol *
# (|plain| + rms(plain)). Both quantize with the same exact abs-max and an
# IEEE division, sum the same int8 products exactly and dequantize with the
# same uncontracted f32 operations, so they should agree bit for bit. The
# limits allow a few f32 ulps, and in bf16 one output rounding flipped by
# such an ulp (2^-8 of |y|).
INT8_CONV_TOLERANCE = {torch.float32: 1e-6, torch.bfloat16: 4e-3}


class QuantizedWeight(NamedTuple):
    """A 3x3 conv's weight in the kernel's layout: ``wq`` (9, Cout, Cin)
    int8 with tap = 3 * di + dj and the input channel contiguous, and
    ``scale`` (Cout,) f32."""

    wq: torch.Tensor
    scale: torch.Tensor


def int8_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax / 127 + 1e-30`` in f32 with an IEEE division. (Divided by a
    tensor on absmax's device: for a Python-number divisor PyTorch's CUDA
    kernel multiplies by the reciprocal, which can differ in the last bit.)"""
    return absmax.float() / torch.full((), 127.0, device=absmax.device) + 1e-30


def quantize_weight(weight: torch.Tensor) -> QuantizedWeight:
    """Symmetric per-output-channel int8 of an OIHW (Cout, Cin, 3, 3)
    weight, taken from its f32 values (never from a bf16 cast)."""
    w = weight.detach().float()
    scale = int8_scale(w.abs().amax(dim=(1, 2, 3)))
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127).to(torch.int8)
    cout, cin = w.shape[:2]
    return QuantizedWeight(wq.permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous(),
                           scale.contiguous())


def activation_scale(v: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale ``max |v| / 127 + 1e-30`` as an f32 0-d tensor."""
    return int8_scale(v.float().abs().amax())


def int8_matmul_conv(vq: torch.Tensor, qw: QuantizedWeight) -> torch.Tensor:
    """Exact integer 3x3 SAME conv of int-valued NHWC ``vq`` with ``qw``,
    in float64, rounded to f32 once."""
    cout, cin = qw.wq.shape[1:]
    w = qw.wq.reshape(3, 3, cout, cin).permute(2, 3, 0, 1).double()
    acc = F.conv2d(vq.double().permute(0, 3, 1, 2), w, padding=1)
    return acc.permute(0, 2, 3, 1).float()


def conv3x3_int8_plain(x: torch.Tensor, qw: QuantizedWeight, bias: Optional[torch.Tensor],
                       dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: NHWC ``x`` (B, H, W, Cin) -> (B, H, W, Cout)
    in ``dtype``."""
    vf = x.float()
    s = activation_scale(vf)
    vq = torch.clamp(torch.round(vf / s), -127, 127)
    out = int8_matmul_conv(vq, qw) * (s * qw.scale)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"conv3x3_int8: {msg}")


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's shared library, built if needed, argument types set once."""
    from shineon_tpu_torch.ops.cuda_build import load_library

    lib = load_library(KERNEL_SOURCE)
    fn = lib.int8_conv3x3_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.int8_conv3x3_error_string.restype = ctypes.c_char_p
    lib.int8_conv3x3_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(x, qw: QuantizedWeight, bias, dtype) -> torch.Tensor:
    """Validate and launch the CUDA kernel on the current stream."""
    _check(x.dim() == 4, "x must be (B, H, W, Cin)")
    B, H, W, cin = x.shape
    _check(dtype in (torch.float32, torch.bfloat16), f"dtype {dtype} not supported")
    _check(x.dtype == dtype, f"x is {x.dtype}; the kernel reads and writes {dtype}")
    _check(qw.wq.dim() == 3 and qw.wq.shape[0] == 9 and qw.wq.shape[2] == cin,
           f"wq has shape {tuple(qw.wq.shape)}, expected (9, Cout, {cin})")
    cout = qw.wq.shape[1]
    _check(cin % CHANNEL_TILE == 0 and cout % CHANNEL_TILE == 0,
           f"Cin={cin} and Cout={cout} must be multiples of {CHANNEL_TILE}")
    _check(qw.wq.dtype == torch.int8, f"wq has dtype {qw.wq.dtype}, expected int8")
    _check(qw.scale.dtype == torch.float32 and tuple(qw.scale.shape) == (cout,),
           "scale must be f32 (Cout,)")
    if bias is not None:
        bias = bias.float().contiguous()
        _check(tuple(bias.shape) == (cout,), f"bias has shape {tuple(bias.shape)}")
    for name, t in (("x", x), ("wq", qw.wq), ("scale", qw.scale), ("bias", bias)):
        if t is not None:
            _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
            _check(t.is_contiguous(), f"{name} must be contiguous")

    lib = _library()
    absmax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
    y = torch.empty((B, H, W, cout), dtype=dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_conv3x3_forward(
            int(dtype == torch.bfloat16), x.data_ptr(), absmax.data_ptr(), qw.wq.data_ptr(),
            qw.scale.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
            B, H, W, cin, cout, stream)
    if err != 0:
        msg = lib.int8_conv3x3_error_string(err).decode()
        raise RuntimeError(f"int8_conv3x3 kernel launch failed: {msg} ({err})")
    conv3x3_int8.launches += 1
    return y


def conv3x3_int8(x: torch.Tensor, qw: QuantizedWeight, bias: Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """Symmetric-int8 3x3 SAME conv of NHWC ``x`` with the quantized weight
    ``qw``, output in ``dtype``: the kernel on a CUDA tensor, the plain
    version on a CPU tensor. Forward only (serving)."""
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, qw, bias, dtype)
    return _launch(x.contiguous(), qw, bias, dtype)


conv3x3_int8.launches = 0
