"""Fused MultiSPADE modulation chain (counterpart of shineon_tpu/ops/fused_spade.py).

For each label in sorted order the chain runs segmap -> 3x3 conv -> 128-wide
hidden map -> 3x3 conv -> [gamma | beta] and applies

    x <- (x * a_l + b_l) * (1 + gamma_l) + beta_l        (x carried in f32)

where (a_l, b_l) is the label's norm folded to per-channel coefficients.

* :func:`multispade_modulate_plain` is the plain PyTorch version, step for
  step the JAX package's ``multispade_modulate_reference``.
* :func:`multispade_modulate_plain_int8` is the plain version of the
  quantized chain (``quantized=True``), step for step the JAX package's
  ``multispade_modulate_reference_int8``: each label's hidden map is
  quantized to int8 with ONE scale over the whole batch tensor, the
  [gamma | beta] conv sums int8 products exactly and is dequantized with the
  per-output-channel weight scales (see ops/int8_conv.py).
* :func:`fused_multispade_modulate` is the wrapper. On a CUDA tensor it
  launches the hand-written kernels of ``csrc/fused_multispade.cu`` or
  raises; on a CPU tensor it computes the plain version. Each launch adds
  one to a count on the wrapper: ``launches`` (the full-precision chain),
  ``int8_launches`` (the quantized chain) and ``absmax_launches`` (the
  quantized chain's pre-pass, which takes each label's hidden abs-max).
* Gradients go through :class:`FusedMultiSpade`, whose backward recomputes
  through the full-precision plain version (serving never needs it).

Weights use the port's layout: OIHW ``wsh`` (128, cs, 3, 3) and ``wgb``
(2C, 128, 3, 3) with gamma's C output channels first.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from shineon_tpu_torch.networks.activation import get_activation_fn
from shineon_tpu_torch.ops.int8_conv import conv3x3_int8_plain, quantize_levels, swizzle_128b

NHID = 128  # hidden width of the SPADE MLP (reference spade.py:68)
CHANNEL_TILE = 64  # the kernel takes C in multiples of this (other C are zero-padded)
MAX_LABELS = 8  # a label may have any number of segmap channels
KERNEL_SOURCE = "fused_multispade"


# The hidden activations the kernels take, by their code in
# csrc/fused_multispade.cu (enum Act)
ACTIVATIONS = ("relu", "gelu", "swish", "sine")


def _act(name: str):
    """The hidden activation, networks/activation.py's: relu, gelu (tanh
    form), swish, sine = sin(30 v)."""
    return get_activation_fn(name)


def _conv3x3(v, weight, bias, dtype):
    """flax nn.Conv(dtype=cd) semantics on NHWC: cast, SAME zero pad, add
    the bias in the compute dtype."""
    out = F.conv2d(v.to(dtype).permute(0, 3, 1, 2), weight.to(dtype), padding=1)
    return out.permute(0, 2, 3, 1) + bias.to(dtype)


# Kernel against plain version: |kernel - plain| <= tol * (|plain| + rms(plain))
# at every element. The rms term covers elements where the chain's terms
# cancel. The sources of difference are the accumulation order and, in bf16,
# where each side rounds (the plain version rounds each conv output and its
# bias sum to bf16, the kernel keeps gamma/beta in f32). On an H100 at the
# serving clip's sites (chip_smoke.py inputs) the bf16 kernel reads up to
# 0.087 and f32 up to 2.0e-5; a bf16 body with the hidden halo unmasked or a
# bias dropped reads 0.27 or more.
#
# The quantized chain, keyed (dtype, "int8"), is held to two limits: this
# elementwise one and INT8_RMS_TOLERANCE on rms(kernel - plain) / rms(plain).
# Both sides round the hidden map alike (in bf16: the conv's sum, then its
# sum with the bias), sum the same int8 products exactly and keep
# gamma/beta in f32, so they differ only where a hidden value, its f32 sum
# taken in another order, rounds the other way and lands on the other side
# of a quantization step. One such flip moves gamma/beta by at most
# s_l * max|w| at the 9 pixels around it: a few elements read up to the
# elementwise limit, and the rms barely moves. A fault in the int8 stage
# moves every element a little: the rms limit is the one that tells it from
# flips. On an H100 at the serving clip's sites (chip_smoke.py inputs) the
# kernel reads up to 0.0081 elementwise and rms 6.6e-5 in bf16 (f32: 2.0e-6,
# 1.0e-7); its controls, the fp chain and gamma/beta weights quantized from
# their bf16 cast, read rms 0.0050 or more; faults planted in the bf16-only
# code (hidden map rounded once, pre-pass abs-max unrounded, hidden channel
# pairs swapped) read 0.0034 or more. On the CPU
# (tests/test_torch_int8.py, emulated kernel) one scale a sample in place of
# one a tensor reads rms 0.0086 or more.
#
# Sine, sin(30 v), in bf16 takes a flip further: where the two sides' f32
# sums round the pre-activation v to neighbouring bf16 values, its hidden
# value moves by up to 30 ulp(v), tens of quantization steps, as it moves
# the bf16 chain's hidden value. So its quantized chain's elementwise limit,
# keyed (bf16, "int8", "sine"), is the bf16 chain's; the rms limit, the one
# that tells an int8 fault from flips, stays.
KERNEL_TOLERANCE = {
    torch.float32: 2e-4,
    torch.bfloat16: 0.15,
    (torch.float32, "int8"): 0.0225,
    (torch.bfloat16, "int8"): 0.0225,
    (torch.bfloat16, "int8", "sine"): 0.15,
}
INT8_RMS_TOLERANCE = 1e-3


def error_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (|ref| + rms(ref)) over the elements, in f32."""
    out, ref = out.float(), ref.float()
    rms = ref.square().mean().sqrt()
    return ((out - ref).abs() / (ref.abs() + rms)).max().item()


def rms_error_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """rms(out - ref) / rms(ref), in f32."""
    out, ref = out.float(), ref.float()
    return ((out - ref).square().mean().sqrt() / ref.square().mean().sqrt()).item()


def int8_limit(dtype, act_name: str = "relu") -> float:
    """The quantized chain's elementwise limit for ``dtype`` and the hidden
    activation."""
    return KERNEL_TOLERANCE.get((dtype, "int8", act_name), KERNEL_TOLERANCE[(dtype, "int8")])


def int8_chain_agrees(out: torch.Tensor, ref: torch.Tensor, act_name: str = "relu") -> tuple:
    """(ok, elementwise ratio, rms ratio) of a quantized chain's output
    against its plain version, under the int8 limits of ``ref.dtype`` and
    the hidden activation."""
    ratio, rms = error_ratio(out, ref), rms_error_ratio(out, ref)
    ok = (bool(torch.isfinite(out.float()).all())
          and ratio <= int8_limit(ref.dtype, act_name) and rms <= INT8_RMS_TOLERANCE)
    return ok, ratio, rms


def multispade_modulate_plain(x, ab, segs, wshs, bshs, wgbs, bgbs, act_name="relu"):
    """Plain PyTorch chain, conv by conv.

    x (B, H, W, C); ab (B, L, 2C) f32; per label: segs[l] (B, H, W, cs)
    already at x's resolution, wshs[l] (128, cs, 3, 3), bshs[l] (128,),
    wgbs[l] (2C, 128, 3, 3), bgbs[l] (2C,). Returns x's shape and dtype.
    """
    act = _act(act_name)
    C = x.shape[-1]
    cd = x.dtype
    out = x.float()
    for l in range(len(segs)):
        h = act(_conv3x3(segs[l], wshs[l], bshs[l], cd).float()).to(cd)
        gb = _conv3x3(h, wgbs[l], bgbs[l], cd).float()
        gamma, beta = gb[..., :C], gb[..., C:]
        a = ab[:, l, :C].float()[:, None, None, :]
        b = ab[:, l, C:].float()[:, None, None, :]
        out = (out * a + b) * (1.0 + gamma) + beta
    return out.to(x.dtype)


def multispade_modulate_plain_int8(x, ab, segs, wshs, bshs, wgbs, bgbs, act_name="relu"):
    """Plain PyTorch quantized chain; arguments as
    :func:`multispade_modulate_plain`. The hidden map is computed and
    rounded to the compute dtype as there, then the [gamma | beta] conv is
    the int8 conv of ops/int8_conv.py (per-tensor activation scale, weights
    quantized from f32), dequantized in f32."""
    act = _act(act_name)
    C = x.shape[-1]
    cd = x.dtype
    out = x.float()
    for l in range(len(segs)):
        h = act(_conv3x3(segs[l], wshs[l], bshs[l], cd).float()).to(cd)
        gb = conv3x3_int8_plain(h, quantize_levels(wgbs[l]), bgbs[l], torch.float32)
        gamma, beta = gb[..., :C], gb[..., C:]
        a = ab[:, l, :C].float()[:, None, None, :]
        b = ab[:, l, C:].float()[:, None, None, :]
        out = (out * a + b) * (1.0 + gamma) + beta
    return out.to(x.dtype)


class PackedWeights(NamedTuple):
    """The kernel's weight operands for one chain and compute dtype, at
    ``Cp = padded_channels(C)`` channels: gamma and beta each zero-padded
    from C to Cp output channels (zero weights and biases, so a padded
    channel of x, itself zero, stays zero and is dropped).

    bf16 (the serving kernels; see ``csrc/fused_multispade.cu``):
      wsh (S, 128, HIDDEN_DEPTH), S the labels' 8-channel segments
      (ceil(cs_l / 8) a label, label by label): segment s of a label holds
      its channels 8s..8s+7 at k = tap * 8 + ci - 8s, zero past cs_l and for
      k >= 72 (each label's segmap is padded to whole segments of
      SEG_CHANNELS);
      wgb (L, 9, Cp / 64, 16384): one slice image a (label, tap, 64-channel
      tile j), the [gamma | beta] rows n = 0..127 (n < 64: gamma channel
      64j + n; n >= 64: beta channel Cp + 64j + n - 64) K-major in the
      128-byte swizzle the kernel's wgmma descriptor reads: bf16 in two
      K-halves of 64 ([h][n][64]), int8 (quantized) in one ([n][128]).
    f32 (the parity kernels): wsh per label (9, cs_l, 128), labels
      concatenated, flat; wgb (L, 9, 128, 2Cp), or quantized (L, 9, 2Cp, 128)
      int8.
    quantized (either dtype): wgb int8, quantized from the f32 weights, and
      sgb (L, 2Cp) f32 its per-output-channel scales.
    """

    cs: tuple  # segmap channels per label
    wsh: torch.Tensor  # values rounded to the compute dtype
    bsh: torch.Tensor  # (L, 128) f32
    wgb: torch.Tensor
    bgb: torch.Tensor  # (L, 2Cp) f32
    sgb: Optional[torch.Tensor] = None  # quantized only


SEG_CHANNELS = 8  # the bf16 kernels' segmap channels a segment; a label has ceil(cs / 8)
HIDDEN_DEPTH = 80  # the bf16 kernels' hidden-conv depth a segment: 9 * SEG_CHANNELS padded to 16
SLICE_ELEMS = 2 * CHANNEL_TILE * NHID  # elements of a slice image (bf16 or int8)


def segments(cs: int) -> int:
    """The bf16 kernels' 8-channel segments of a label of cs channels."""
    return -(-cs // SEG_CHANNELS)


def padded_channels(C: int) -> int:
    """C rounded up to the kernels' channel tile."""
    return -(-C // CHANNEL_TILE) * CHANNEL_TILE


def _packed_shapes(dtype, cs, Cp, quantized=False):
    L = len(cs)
    if dtype == torch.bfloat16:
        S = sum(segments(c) for c in cs)
        return (S, NHID, HIDDEN_DEPTH), (L, 9, Cp // CHANNEL_TILE, SLICE_ELEMS)
    wsh = (9 * sum(cs) * NHID,)
    wgb = (L, 9, 2 * Cp, NHID) if quantized else (L, 9, NHID, 2 * Cp)
    return wsh, wgb


def _pad_gamma_beta(v: torch.Tensor, Cp: int) -> torch.Tensor:
    """[gamma | beta] along dim 0 (2C, ...) -> (2Cp, ...), each half
    zero-padded from C to Cp."""
    C = v.shape[0] // 2
    if C == Cp:
        return v
    pad = v.new_zeros((Cp - C,) + tuple(v.shape[1:]))
    return torch.cat([v[:C], pad, v[C:], pad])


@functools.lru_cache(maxsize=None)
def slice_index(C: int, int8: bool) -> torch.Tensor:
    """Where each element of a tap's slice images comes from: (C / 64 *
    SLICE_ELEMS,) flat indices into the tap's (2C, 128) [gamma | beta] rows.
    Image j holds rows n = 0..127 (n < 64: gamma channel 64j + n, else beta
    channel C + 64j + n - 64), K-major and 128-byte swizzled: int8 as
    [n][128], bf16 as two K-halves [h][n][64]."""
    T = C // CHANNEL_TILE
    ids = torch.arange(2 * C * NHID).reshape(2, T, CHANNEL_TILE, NHID)
    n = ids.transpose(0, 1).reshape(T, 2 * CHANNEL_TILE, NHID)  # (T, 128 n, 128 k)
    if not int8:
        n = n.reshape(T, 2 * CHANNEL_TILE, 2, NHID // 2).transpose(1, 2)
    return swizzle_128b(n).reshape(-1)


def slice_images(wt: torch.Tensor) -> torch.Tensor:
    """(9, 2C, 128) tap-major [gamma | beta] weights, bf16 or int8 -> (9,
    C / 64, SLICE_ELEMS) slice images (:func:`slice_index`)."""
    C = wt.shape[1] // 2
    idx = slice_index(C, wt.dtype == torch.int8).to(wt.device)
    return wt.reshape(9, -1)[:, idx].reshape(9, C // CHANNEL_TILE, SLICE_ELEMS)


def unpack_slice_images(img: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`slice_images`: (9, C / 64, SLICE_ELEMS) ->
    (9, 2C, 128)."""
    C = img.shape[1] * CHANNEL_TILE
    out = img.new_empty(9, 2 * C * NHID)
    out[:, slice_index(C, img.dtype == torch.int8).to(img.device)] = img.reshape(9, -1)
    return out.reshape(9, 2 * C, NHID)


def kernel_segmap(segs, dtype) -> torch.Tensor:
    """The labels' segmaps as one kernel operand (B, H, W, ...) in
    ``dtype``: bf16 pads each label to whole segments of SEG_CHANNELS
    channels (16 bytes a position a segment), f32 concatenates them as they
    are."""
    if dtype == torch.bfloat16:
        segs = [F.pad(s.to(dtype), (0, SEG_CHANNELS * segments(s.shape[-1]) - s.shape[-1]))
                for s in segs]
    return torch.cat([s.to(dtype) for s in segs], dim=-1).contiguous()


def _hidden_segments(w: torch.Tensor, dtype) -> torch.Tensor:
    """A label's OIHW hidden weight (128, cs, 3, 3) as the bf16 kernels'
    (segments(cs), 128, HIDDEN_DEPTH) blocks: k = tap * 8 + ci within a
    segment."""
    S = segments(w.shape[1])
    w = F.pad(w.to(dtype), (0, 0, 0, 0, 0, SEG_CHANNELS * S - w.shape[1]))
    w = w.reshape(NHID, S, SEG_CHANNELS, 9).permute(1, 0, 3, 2).reshape(S, NHID, 9 * SEG_CHANNELS)
    return F.pad(w, (0, HIDDEN_DEPTH - 9 * SEG_CHANNELS))


def pack_weights(wshs, bshs, wgbs, bgbs, dtype, quantized=False) -> PackedWeights:
    """Rearrange per-label OIHW weights into the kernel's layout, at
    ``padded_channels(C)`` channels; with ``quantized`` the [gamma | beta]
    weights become int8 with their scales."""
    cs = tuple(int(w.shape[1]) for w in wshs)
    sgb = None
    bf16 = dtype == torch.bfloat16
    Cp = padded_channels(wgbs[0].shape[0] // 2)
    wgbs = [_pad_gamma_beta(w, Cp) for w in wgbs]
    bgbs = [_pad_gamma_beta(b, Cp) for b in bgbs]
    if bf16:
        wsh = torch.cat([_hidden_segments(w, dtype) for w in wshs])
    else:
        wsh = torch.cat([w.to(dtype).permute(2, 3, 1, 0).reshape(-1) for w in wshs])
    if quantized:
        qws = [quantize_levels(w) for w in wgbs]  # from the f32 weights; wq (9, 2C, 128)
        wgb = torch.stack([slice_images(q.wq) if bf16 else q.wq for q in qws])
        sgb = torch.stack([q.scale for q in qws]).contiguous()
    elif bf16:
        wgb = torch.stack([slice_images(w.to(dtype).permute(2, 3, 0, 1).reshape(9, w.shape[0], NHID))
                           for w in wgbs])
    else:
        wgb = torch.stack([w.to(dtype).permute(2, 3, 1, 0).reshape(9, NHID, w.shape[0])
                           for w in wgbs])
    return PackedWeights(
        cs=cs,
        wsh=wsh.contiguous(),
        bsh=torch.stack([b.float() for b in bshs]).contiguous(),
        wgb=wgb.contiguous(),
        bgb=torch.stack([b.float() for b in bgbs]).contiguous(),
        sgb=sgb,
    )


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"fused_multispade_modulate: {msg}")


def pad_channels(x: torch.Tensor, ab: torch.Tensor, Cp: int):
    """x (B, H, W, C) and ab (B, L, 2C) zero-padded to Cp channels (ab's
    a and b halves each): a padded channel of x is zero and stays zero
    through the chain, so the first C channels of its output are exactly the
    unpadded chain's."""
    C = x.shape[-1]
    if C == Cp:
        return x, ab
    return (F.pad(x, (0, Cp - C)).contiguous(),
            _pad_gamma_beta(ab.transpose(0, 2), Cp).transpose(0, 2).contiguous())


def _launch(x, ab, seg, packed: PackedWeights, act_name: str) -> torch.Tensor:
    """Validate and launch the CUDA kernel (quantized: the pre-pass, then
    the quantized chain) on the current stream, on x and ab zero-padded to
    the packed weights' channels."""
    quantized = packed.sgb is not None
    _check(act_name in ACTIVATIONS, f"activation {act_name!r} (one of {ACTIVATIONS})")
    _check(x.dim() == 4, "x must be (B, H, W, C)")
    B, H, W, C = x.shape
    Cp = padded_channels(C)
    L = len(packed.cs)
    _check(x.dtype in (torch.float32, torch.bfloat16), f"dtype {x.dtype} not supported")
    _check(1 <= L <= MAX_LABELS, f"{L} labels (at most {MAX_LABELS})")
    _check(all(c >= 1 for c in packed.cs), f"segmap channels {packed.cs} (at least 1 a label)")
    _check(tuple(ab.shape) == (B, L, 2 * C), f"ab has shape {tuple(ab.shape)}, expected "
           f"{(B, L, 2 * C)}")
    x, ab = pad_channels(x, ab, Cp)
    wsh_shape, wgb_shape = _packed_shapes(x.dtype, packed.cs, Cp, quantized)
    seg_c = (SEG_CHANNELS * sum(segments(c) for c in packed.cs) if x.dtype == torch.bfloat16
             else sum(packed.cs))
    expect = {
        "ab": (ab, (B, L, 2 * Cp), torch.float32),
        "seg": (seg, (B, H, W, seg_c), x.dtype),
        "wsh": (packed.wsh, wsh_shape, x.dtype),
        "bsh": (packed.bsh, (L, NHID), torch.float32),
        "wgb": (packed.wgb, wgb_shape, torch.int8 if quantized else x.dtype),
        "bgb": (packed.bgb, (L, 2 * Cp), torch.float32),
    }
    if quantized:
        expect["sgb"] = (packed.sgb, (L, 2 * Cp), torch.float32)
    tensors = {"x": x}
    for name, (t, shape, dtype) in expect.items():
        _check(tuple(t.shape) == shape, f"{name} has shape {tuple(t.shape)}, expected {shape}")
        _check(t.dtype == dtype, f"{name} has dtype {t.dtype}, expected {dtype}")
        tensors[name] = t
    for name, t in tensors.items():
        _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")

    y = torch.empty_like(x)
    lib, call = _library()
    cs = (ctypes.c_int * L)(*packed.cs)
    is_bf16 = int(x.dtype == torch.bfloat16)
    act = ACTIVATIONS.index(act_name)
    if not quantized:
        call(lib.multispade_chain_forward, "fused_multispade", x.device, is_bf16, act,
             x.data_ptr(), ab.data_ptr(), seg.data_ptr(), packed.wsh.data_ptr(),
             packed.bsh.data_ptr(), packed.wgb.data_ptr(), packed.bgb.data_ptr(), y.data_ptr(),
             B, H, W, Cp, L, cs)
        fused_multispade_modulate.launches += 1
        return y if C == Cp else y[..., :C].contiguous()
    absmax = hidden_absmax(seg, packed, act_name)
    call(lib.multispade_chain_forward_int8, "fused_multispade_int8", x.device, is_bf16, act,
         x.data_ptr(), ab.data_ptr(), seg.data_ptr(), packed.wsh.data_ptr(),
         packed.bsh.data_ptr(), packed.wgb.data_ptr(), packed.sgb.data_ptr(),
         packed.bgb.data_ptr(), absmax.data_ptr(), y.data_ptr(), B, H, W, Cp, L, cs)
    fused_multispade_modulate.int8_launches += 1
    return y if C == Cp else y[..., :C].contiguous()


@functools.lru_cache(maxsize=None)
def _library():
    """The chain's shared library with its argument types (set once), and a
    caller that launches one of its functions on the current stream of a
    device and raises on a launch error."""
    from shineon_tpu_torch.ops.cuda_build import load_library

    lib = load_library(KERNEL_SOURCE)
    cs_arg = [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.multispade_chain_forward.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + cs_arg)
    lib.multispade_hidden_absmax.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + cs_arg)
    lib.multispade_chain_forward_int8.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + cs_arg)
    for fn in (lib.multispade_chain_forward, lib.multispade_hidden_absmax,
               lib.multispade_chain_forward_int8):
        fn.restype = ctypes.c_int
    lib.multispade_chain_error_string.restype = ctypes.c_char_p
    lib.multispade_chain_error_string.argtypes = [ctypes.c_int]

    def call(fn, what, device, *args):
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            msg = lib.multispade_chain_error_string(err).decode()
            raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")

    return lib, call


def hidden_absmax(seg: torch.Tensor, packed: PackedWeights, act_name: str = "relu") -> torch.Tensor:
    """The quantized chain's pre-pass on the card: (L,) f32 max |hidden_l|
    over the batch, each label's activated hidden map computed by the
    chain's own device code. ``seg`` from :func:`kernel_segmap` in the
    compute dtype; ``packed`` and ``act_name`` as for the chain. Adds one to
    ``fused_multispade_modulate.absmax_launches``."""
    B, H, W, _ = seg.shape
    L = len(packed.cs)
    lib, call = _library()
    absmax = torch.empty(L, dtype=torch.float32, device=seg.device)
    call(lib.multispade_hidden_absmax, "multispade_hidden_absmax", seg.device,
         int(seg.dtype == torch.bfloat16), ACTIVATIONS.index(act_name), seg.data_ptr(),
         packed.wsh.data_ptr(), packed.bsh.data_ptr(), absmax.data_ptr(), B, H, W, L,
         (ctypes.c_int * L)(*packed.cs))
    fused_multispade_modulate.absmax_launches += 1
    return absmax


class FusedMultiSpade(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU), quantized or
    not. Backward: recompute through the full-precision plain version, like
    the JAX package's ``_fused_bwd``.

    Inputs are flattened: ``apply(act_name, quantized, packed, L, x, ab,
    *segs, *wshs, *bshs, *wgbs, *bgbs)``; ``packed`` may be None (packed on
    the fly)."""

    @staticmethod
    def forward(ctx, act_name, quantized, packed, L, x, ab, *flat):
        segs, wshs, bshs, wgbs, bgbs = (list(flat[i * L:(i + 1) * L]) for i in range(5))
        ctx.act_name, ctx.L = act_name, L
        ctx.save_for_backward(x, ab, *flat)
        if x.device.type == "cpu":
            plain = multispade_modulate_plain_int8 if quantized else multispade_modulate_plain
            return plain(x, ab, segs, wshs, bshs, wgbs, bgbs, act_name)
        if packed is None:
            packed = pack_weights(wshs, bshs, wgbs, bgbs, x.dtype, quantized)
        if (packed.sgb is not None) != quantized:
            raise ValueError("fused_multispade_modulate: packed weights do not match quantized")
        seg = kernel_segmap(segs, x.dtype)
        return _launch(x.contiguous(), ab.float().contiguous(), seg, packed, act_name)

    @staticmethod
    def backward(ctx, grad):
        x, ab, *flat = ctx.saved_tensors
        L = ctx.L
        inputs = [t.detach().requires_grad_(t.is_floating_point()) for t in (x, ab, *flat)]
        with torch.enable_grad():
            x_, ab_, *rest = inputs
            groups = [rest[i * L:(i + 1) * L] for i in range(5)]
            out = multispade_modulate_plain(x_, ab_, *groups, act_name=ctx.act_name)
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad[4:]) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None, None, None) + tuple(
            next(grads) if need else None for need in ctx.needs_input_grad[4:]
        )


def fused_multispade_modulate(
    x: torch.Tensor,
    ab: torch.Tensor,
    segs: Sequence[torch.Tensor],
    wshs: Sequence[torch.Tensor],
    bshs: Sequence[torch.Tensor],
    wgbs: Sequence[torch.Tensor],
    bgbs: Sequence[torch.Tensor],
    act_name: str = "relu",
    packed: PackedWeights | None = None,
    quantized: bool = False,
) -> torch.Tensor:
    """Apply the sequential multi-label SPADE modulation chain, fused.

    Arguments as :func:`multispade_modulate_plain`; ``packed`` optionally
    carries the weights already in the kernel's layout (see
    :func:`pack_weights`, with the same ``quantized``) so a caller serving
    many frames packs once. ``quantized`` runs the [gamma | beta] conv in
    int8 (:func:`multispade_modulate_plain_int8`), the int8 serving mode.
    """
    L = len(segs)
    return FusedMultiSpade.apply(
        act_name, quantized, packed, L, x, ab, *segs, *wshs, *bshs, *wgbs, *bgbs
    )


fused_multispade_modulate.launches = 0
fused_multispade_modulate.int8_launches = 0
fused_multispade_modulate.absmax_launches = 0
