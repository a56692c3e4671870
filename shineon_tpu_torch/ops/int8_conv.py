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
  hand-written kernels of ``csrc/int8_conv3x3.cu`` or raises; on a CPU
  tensor it computes the plain version. In bf16 that is the quantize pass
  :func:`quantize_int8` (an int8 copy of x; ``quantize_int8.launches``)
  and the conv (``conv3x3_int8.launches``); in f32 the parity kernel alone,
  which quantizes as it loads. The abs-max of x is one PyTorch reduction
  before them.
* The bf16 kernel reads its weights as slice images
  (:func:`conv_slice_images`), made once per conv by :func:`quantize_weight`
  when the weight lies on the card (where the layers cache the quantized
  weight); a bf16 launch without them raises. Any Cin and Cout are taken: the bf16 kernel
  takes the tails itself; the f32 parity kernel gets channels zero-padded
  to multiples of 64 here (exact: zero inputs and weights add nothing, and
  padded outputs are dropped).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from shineon_tpu_torch import tracing

KERNEL_SOURCE = "int8_conv3x3"
CHANNEL_TILE = 64  # the f32 parity kernel takes Cin and Cout in multiples of this

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
    ``scale`` (Cout,) f32; for a weight on the card also ``images``, wq as
    the bf16 kernel's slice images (:func:`conv_slice_images`). ``taps``:
    the conv probe's tap-product kernels' images of wq, where a caller made
    them (``ops/probes.py::with_tap_images``). The plain versions read wq."""

    wq: torch.Tensor
    scale: torch.Tensor
    images: Optional[torch.Tensor] = None
    taps: Optional[tuple] = None


def int8_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``absmax / 127 + 1e-30`` in f32 with an IEEE division. (Divided by a
    tensor on absmax's device: for a Python-number divisor PyTorch's CUDA
    kernel multiplies by the reciprocal, which can differ in the last bit.)"""
    return absmax.float() / torch.full((), 127.0, device=absmax.device) + 1e-30


def quantize_levels(weight: torch.Tensor) -> QuantizedWeight:
    """Symmetric per-output-channel int8 of an OIHW (Cout, Cin, 3, 3)
    weight, taken from its f32 values (never from a bf16 cast): wq and
    scale, no slice images (what the plain version reads)."""
    w = weight.detach().float()
    scale = int8_scale(w.abs().amax(dim=(1, 2, 3)))
    wq = torch.clamp(torch.round(w / scale[:, None, None, None]), -127, 127).to(torch.int8)
    cout, cin = w.shape[:2]
    wq = wq.permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()
    return QuantizedWeight(wq, scale.contiguous())


def quantize_weight(weight: torch.Tensor) -> QuantizedWeight:
    """:func:`quantize_levels`, and for a weight on the card also its slice
    images for the bf16 kernel."""
    qw = quantize_levels(weight)
    return qw._replace(images=conv_slice_images(qw.wq)) if weight.is_cuda else qw


def swizzle_128b(rows: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of rows of 128 bytes (..., N, E), E = 128 /
    itemsize: 16-byte chunk p of row n holds chunk p ^ (n % 8). Its own
    inverse."""
    *lead, n, e = rows.shape
    chunks = rows.reshape(*lead, n, 8, e // 8)
    idx = torch.arange(8)[None, :] ^ (torch.arange(n) % 8)[:, None]  # (N, 8)
    idx = idx.to(rows.device)[..., None].expand(n, 8, e // 8).expand(*lead, n, 8, e // 8)
    return chunks.gather(-2, idx).reshape(rows.shape)


class ConvMode(NamedTuple):
    """The bf16 kernel's tiling of K and N for a conv's widths: input
    channels in chunks of ``kc`` (64 where Cin <= 64: two taps a 128-byte
    slice and a tenth tap of zeros; else 128: one tap a slice), output
    channels in blocks of ``n_t`` (64, 128 or 256)."""

    kc: int
    n_t: int

    @property
    def slices(self) -> int:  # slices a chunk
        return 9 if self.kc == 128 else 5


def conv_mode(cin: int, cout: int) -> ConvMode:
    """The tiling the kernel takes for these widths (csrc/int8_conv3x3.cu:
    config)."""
    return ConvMode(64 if cin <= 64 else 128, 64 if cout <= 64 else 128 if cout <= 128 else 256)


def conv_slice_images(wq: torch.Tensor) -> torch.Tensor:
    """(9, Cout, Cin) int8 weights -> the bf16 kernel's slice images, (nblk,
    nchunks, slices, n_t, 128) int8 (:func:`conv_mode`): image (j, c, s)
    holds, for output channel j * n_t + n, row n, the 128 bytes of K of
    slice s of input-channel chunk c: with kc = 128, tap s and channels
    128c..128c+127; with kc = 64, taps 2s and 2s + 1 (bytes 0-63, 64-127),
    channels 64c..64c+63. Past Cin, Cout or tap 8: zeros. Each row
    128-byte swizzled (:func:`swizzle_128b`) for the kernel's descriptor."""
    _, cout, cin = wq.shape
    mode = conv_mode(cin, cout)
    nblk, nch = -(-cout // mode.n_t), -(-cin // mode.kc)
    taps = 9 if mode.kc == 128 else 10
    w = wq.new_zeros(taps, nblk * mode.n_t, nch * mode.kc)
    w[:9, :cout, :cin] = wq
    w = w.reshape(taps, nblk, mode.n_t, nch, mode.kc)
    if mode.kc == 128:  # (tap, j, n, c, k) -> (j, c, tap, n, k)
        img = w.permute(1, 3, 0, 2, 4)
    else:  # (s, half, j, n, c, k) -> (j, c, s, n, half, k)
        img = w.reshape(5, 2, nblk, mode.n_t, nch, 64).permute(2, 4, 0, 3, 1, 5)
    img = img.reshape(nblk, nch, mode.slices, mode.n_t, 128)
    return swizzle_128b(img).contiguous()


def unpack_conv_slice_images(img: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """The inverse of :func:`conv_slice_images`: the (9, Cout, Cin) weights."""
    mode = conv_mode(cin, cout)
    nblk, nch = img.shape[:2]
    w = swizzle_128b(img)
    if mode.kc == 128:
        w = w.permute(2, 0, 3, 1, 4)  # (tap, j, n, c, k)
    else:
        w = w.reshape(nblk, nch, 5, mode.n_t, 2, 64).permute(2, 4, 0, 3, 1, 5)
    w = w.reshape(-1, nblk * mode.n_t, nch * mode.kc)
    return w[:9, :cout, :cin].contiguous()


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
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.int8_conv3x3_plan.restype = ctypes.c_int
    lib.int8_conv3x3_plan.argtypes = [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    lib.int8_conv3x3_quantize.restype = ctypes.c_int
    lib.int8_conv3x3_quantize.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.int8_conv3x3_error_string.restype = ctypes.c_char_p
    lib.int8_conv3x3_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(lib, err: int, what: str):
    if err != 0:
        msg = lib.int8_conv3x3_error_string(err).decode()
        raise RuntimeError(f"int8_conv3x3 {what} failed: {msg} ({err})")


@functools.lru_cache(maxsize=None)
def plan(B: int, H: int, W: int, cin: int, cout: int, device: int = 0) -> tuple:
    """The bf16 kernel's plan on card ``device``: (int32 workspace ints, K
    split)."""
    lib = _library()
    ints, split = ctypes.c_longlong(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.int8_conv3x3_plan(B, H, W, cin, cout, ctypes.byref(ints), ctypes.byref(split))
    _raise_on(lib, err, "plan")
    return ints.value, split.value


def quantized_channels(cin: int) -> int:
    """Channels a pixel of :func:`quantize_int8`'s copy holds: Cin rounded
    up to 16 (16-byte rows, as the conv's tensor-map copies need)."""
    return -(-cin // 16) * 16


def quantize_int8_plain(x: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """Plain version of the quantize pass: clip(round(x / s), -127, 127) as
    int8, s = absmax / 127 + 1e-30 (an IEEE division), zero past Cin up to
    quantized_channels(Cin)."""
    q = torch.clamp(torch.round(x.float() / int8_scale(absmax)), -127, 127).to(torch.int8)
    return F.pad(q, (0, quantized_channels(x.shape[-1]) - x.shape[-1]))


def quantize_int8(x: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """The bf16 conv's quantize pass: NHWC bf16 ``x`` and its abs-max (an f32
    0-d tensor) -> (B, H, W, quantized_channels(Cin)) int8. The kernel on a
    CUDA tensor (adds one to ``quantize_int8.launches``), the plain version
    on a CPU tensor."""
    if x.device.type == "cpu":
        return quantize_int8_plain(x, absmax)
    _check(x.dim() == 4 and x.dtype == torch.bfloat16 and x.is_contiguous(),
           "the quantize pass takes contiguous (B, H, W, Cin) bf16")
    _check(absmax.dtype == torch.float32 and absmax.numel() == 1 and absmax.device == x.device,
           "absmax must be one f32 on x's device")
    B, H, W, cin = x.shape
    lib = _library()
    xq = torch.empty((B, H, W, quantized_channels(cin)), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_conv3x3_quantize(x.data_ptr(), absmax.data_ptr(), xq.data_ptr(),
                                        B * H * W, cin, stream)
    _raise_on(lib, err, "quantize launch")
    quantize_int8.launches += 1
    return xq


quantize_int8.launches = 0


def _pad_f32_operands(x, qw: QuantizedWeight, bias):
    """The f32 parity kernel's operands at Cin and Cout zero-padded to
    multiples of CHANNEL_TILE."""
    _, cout, cin = qw.wq.shape
    cinp, coutp = (-(-c // CHANNEL_TILE) * CHANNEL_TILE for c in (cin, cout))
    if (cinp, coutp) == (cin, cout):
        return x, qw.wq, qw.scale, bias
    wq = qw.wq.new_zeros(9, coutp, cinp)
    wq[:, :cout, :cin] = qw.wq
    scale = F.pad(qw.scale, (0, coutp - cout))
    bias = None if bias is None else F.pad(bias, (0, coutp - cout))
    return F.pad(x, (0, cinp - cin)).contiguous(), wq, scale, bias


def _launch(x, qw: QuantizedWeight, bias, dtype) -> torch.Tensor:
    """Validate and launch the CUDA kernel on the current stream."""
    _check(x.dim() == 4, "x must be (B, H, W, Cin)")
    B, H, W, cin = x.shape
    _check(dtype in (torch.float32, torch.bfloat16), f"dtype {dtype} not supported")
    _check(x.dtype == dtype, f"x is {x.dtype}; the kernel reads and writes {dtype}")
    _check(qw.wq.dim() == 3 and qw.wq.shape[0] == 9 and qw.wq.shape[2] == cin,
           f"wq has shape {tuple(qw.wq.shape)}, expected (9, Cout, {cin})")
    cout = qw.wq.shape[1]
    _check(qw.wq.dtype == torch.int8, f"wq has dtype {qw.wq.dtype}, expected int8")
    _check(qw.scale.dtype == torch.float32 and tuple(qw.scale.shape) == (cout,),
           "scale must be f32 (Cout,)")
    if bias is not None:
        bias = bias.float().contiguous()
        _check(tuple(bias.shape) == (cout,), f"bias has shape {tuple(bias.shape)}")
    images = None
    if dtype == torch.bfloat16:
        images = qw.images
        _check(images is not None,
               "the weight has no slice images: quantize_weight makes them for a weight on the card")
        mode = conv_mode(cin, cout)
        want = (-(-cout // mode.n_t), -(-cin // mode.kc), mode.slices, mode.n_t, 128)
        _check(tuple(images.shape) == want and images.dtype == torch.int8,
               f"images have shape {tuple(images.shape)}, expected {want} int8")
    for name, t in (("x", x), ("wq", qw.wq), ("scale", qw.scale), ("bias", bias),
                    ("images", images)):
        if t is not None:
            _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
            _check(t.is_contiguous(), f"{name} must be contiguous")

    lib = _library()
    absmax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
    y = torch.empty((B, H, W, cout), dtype=dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if dtype == torch.bfloat16:
            ints, _ = plan(B, H, W, cin, cout, torch.cuda.current_device())
            ws = torch.empty(ints, dtype=torch.int32, device=x.device) if ints else None
            xq = quantize_int8(x, absmax)
            err = lib.int8_conv3x3_forward(
                1, xq.data_ptr(), absmax.data_ptr(), images.data_ptr(), qw.scale.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(), B, H, W, cin, cout, stream)
        else:
            xp, wq, scale, bp = _pad_f32_operands(x, qw, bias)
            yp = y if xp is x and wq is qw.wq else torch.empty(
                (B, H, W, wq.shape[1]), dtype=dtype, device=x.device)
            err = lib.int8_conv3x3_forward(
                0, xp.data_ptr(), absmax.data_ptr(), wq.data_ptr(), scale.data_ptr(),
                None if bp is None else bp.data_ptr(), yp.data_ptr(), None,
                B, H, W, wq.shape[2], wq.shape[1], stream)
            if yp is not y:
                y.copy_(yp[..., :cout])
    _raise_on(lib, err, "kernel launch")
    conv3x3_int8.launches += 1
    return y
def conv3x3_int8(x: torch.Tensor, qw: QuantizedWeight, bias: Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """Symmetric-int8 3x3 SAME conv of NHWC ``x`` with the quantized weight
    ``qw``, output in ``dtype``: the kernel on a CUDA tensor, the plain
    version on a CPU tensor. Forward only (serving)."""
    if x.device.type == "cpu":
        return conv3x3_int8_plain(x, qw, bias, dtype)
    with tracing.span("int8.conv3x3"):
        return _launch(x.contiguous(), qw, bias, dtype)


conv3x3_int8.launches = 0
