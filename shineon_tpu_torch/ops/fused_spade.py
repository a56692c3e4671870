"""Fused MultiSPADE modulation chain (counterpart of shineon_tpu/ops/fused_spade.py).

For each label in sorted order the chain runs segmap -> 3x3 conv -> 128-wide
hidden map -> 3x3 conv -> [gamma | beta] and applies

    x <- (x * a_l + b_l) * (1 + gamma_l) + beta_l        (x carried in f32)

where (a_l, b_l) is the label's norm folded to per-channel coefficients.

* :func:`multispade_modulate_plain` is the plain PyTorch version, step for
  step the JAX package's ``multispade_modulate_reference``.
* :func:`fused_multispade_modulate` is the wrapper. On a CUDA tensor it
  launches the hand-written kernel ``csrc/fused_multispade.cu`` or raises;
  on a CPU tensor it computes the plain version. Each kernel launch adds one
  to ``fused_multispade_modulate.launches``.
* Gradients go through :class:`FusedMultiSpade`, whose backward recomputes
  through the plain version (serving never needs it).

Weights use the port's layout: OIHW ``wsh`` (128, cs, 3, 3) and ``wgb``
(2C, 128, 3, 3) with gamma's C output channels first.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

NHID = 128  # hidden width of the SPADE MLP (reference spade.py:68)
CHANNEL_TILE = 64  # the kernel takes C in multiples of this
MAX_LABELS = 8
MAX_LABEL_CHANNELS = 8
KERNEL_SOURCE = "fused_multispade"


def _act(name: str):
    if name == "relu":
        return F.relu
    raise NotImplementedError(f"hidden activation {name!r} is not ported")


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
# 0.087 and f32 up to 1.6e-5; a bf16 body with the hidden halo unmasked or a
# bias dropped reads 0.27 or more.
KERNEL_TOLERANCE = {torch.float32: 2e-4, torch.bfloat16: 0.15}


def error_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| / (|ref| + rms(ref)) over the elements, in f32."""
    out, ref = out.float(), ref.float()
    rms = ref.square().mean().sqrt()
    return ((out - ref).abs() / (ref.abs() + rms)).max().item()


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


class PackedWeights(NamedTuple):
    """The kernel's weight operands for one chain and compute dtype.

    bf16 (tensor-core operands, reduction index contiguous):
      wsh (L, 128, kp) with k = tap * cs_l + ci, zero padded to kp = 9 *
      max(cs) rounded up to 16; wgb (L, 9, 2C, 128).
    f32: wsh per label (9, cs_l, 128), labels concatenated, flat;
      wgb (L, 9, 128, 2C).
    """

    cs: tuple  # segmap channels per label
    wsh: torch.Tensor  # values rounded to the compute dtype
    bsh: torch.Tensor  # (L, 128) f32
    wgb: torch.Tensor
    bgb: torch.Tensor  # (L, 2C) f32


def _hidden_depth(cs) -> int:
    return (9 * max(cs) + 15) // 16 * 16


def _packed_shapes(dtype, cs, C):
    L = len(cs)
    if dtype == torch.bfloat16:
        return (L, NHID, _hidden_depth(cs)), (L, 9, 2 * C, NHID)
    return (9 * sum(cs) * NHID,), (L, 9, NHID, 2 * C)


def pack_weights(wshs, bshs, wgbs, bgbs, dtype) -> PackedWeights:
    """Rearrange per-label OIHW weights into the kernel's layout."""
    cs = tuple(int(w.shape[1]) for w in wshs)
    if dtype == torch.bfloat16:
        kp = _hidden_depth(cs)
        wsh = torch.stack([
            F.pad(w.to(dtype).permute(0, 2, 3, 1).reshape(NHID, -1), (0, kp - 9 * w.shape[1]))
            for w in wshs
        ])
        wgb = torch.stack([w.to(dtype).permute(2, 3, 0, 1).reshape(9, w.shape[0], NHID)
                           for w in wgbs])
    else:
        wsh = torch.cat([w.to(dtype).permute(2, 3, 1, 0).reshape(-1) for w in wshs])
        wgb = torch.stack([w.to(dtype).permute(2, 3, 1, 0).reshape(9, NHID, w.shape[0])
                           for w in wgbs])
    return PackedWeights(
        cs=cs,
        wsh=wsh.contiguous(),
        bsh=torch.stack([b.float() for b in bshs]).contiguous(),
        wgb=wgb.contiguous(),
        bgb=torch.stack([b.float() for b in bgbs]).contiguous(),
    )


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"fused_multispade_modulate: {msg}")


def _launch(x, ab, seg, packed: PackedWeights, act_name: str) -> torch.Tensor:
    """Validate and launch the CUDA kernel on the current stream."""
    from shineon_tpu_torch.ops.cuda_build import load_library

    _check(act_name == "relu", f"activation {act_name!r} is not ported to the kernel")
    _check(x.dim() == 4, "x must be (B, H, W, C)")
    B, H, W, C = x.shape
    L = len(packed.cs)
    _check(x.dtype in (torch.float32, torch.bfloat16), f"dtype {x.dtype} not supported")
    _check(C % CHANNEL_TILE == 0, f"C={C} must be a multiple of {CHANNEL_TILE}")
    _check(1 <= L <= MAX_LABELS, f"{L} labels (at most {MAX_LABELS})")
    _check(all(1 <= c <= MAX_LABEL_CHANNELS for c in packed.cs),
           f"segmap channels {packed.cs} (1..{MAX_LABEL_CHANNELS} a label)")
    wsh_shape, wgb_shape = _packed_shapes(x.dtype, packed.cs, C)
    expect = {
        "ab": (ab, (B, L, 2 * C), torch.float32),
        "seg": (seg, (B, H, W, sum(packed.cs)), x.dtype),
        "wsh": (packed.wsh, wsh_shape, x.dtype),
        "bsh": (packed.bsh, (L, NHID), torch.float32),
        "wgb": (packed.wgb, wgb_shape, x.dtype),
        "bgb": (packed.bgb, (L, 2 * C), torch.float32),
    }
    tensors = {"x": x}
    for name, (t, shape, dtype) in expect.items():
        _check(tuple(t.shape) == shape, f"{name} has shape {tuple(t.shape)}, expected {shape}")
        _check(t.dtype == dtype, f"{name} has dtype {t.dtype}, expected {dtype}")
        tensors[name] = t
    for name, t in tensors.items():
        _check(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _check(t.is_contiguous(), f"{name} must be contiguous")

    lib = load_library(KERNEL_SOURCE)
    fn = lib.multispade_chain_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
    ]
    lib.multispade_chain_error_string.restype = ctypes.c_char_p
    lib.multispade_chain_error_string.argtypes = [ctypes.c_int]

    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            int(x.dtype == torch.bfloat16), x.data_ptr(), ab.data_ptr(), seg.data_ptr(),
            packed.wsh.data_ptr(), packed.bsh.data_ptr(), packed.wgb.data_ptr(),
            packed.bgb.data_ptr(), y.data_ptr(), B, H, W, C, L,
            (ctypes.c_int * L)(*packed.cs), stream,
        )
    if err != 0:
        msg = lib.multispade_chain_error_string(err).decode()
        raise RuntimeError(f"fused_multispade kernel launch failed: {msg} ({err})")
    fused_multispade_modulate.launches += 1
    return y


class FusedMultiSpade(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward:
    recompute through the plain version, like the JAX package's
    ``_fused_bwd``.

    Inputs are flattened: ``apply(act_name, packed, L, x, ab, *segs, *wshs,
    *bshs, *wgbs, *bgbs)``; ``packed`` may be None (packed on the fly)."""

    @staticmethod
    def forward(ctx, act_name, packed, L, x, ab, *flat):
        segs, wshs, bshs, wgbs, bgbs = (list(flat[i * L:(i + 1) * L]) for i in range(5))
        ctx.act_name, ctx.L = act_name, L
        ctx.save_for_backward(x, ab, *flat)
        if x.device.type == "cpu":
            return multispade_modulate_plain(x, ab, segs, wshs, bshs, wgbs, bgbs, act_name)
        if packed is None:
            packed = pack_weights(wshs, bshs, wgbs, bgbs, x.dtype)
        seg = torch.cat([s.to(x.dtype) for s in segs], dim=-1).contiguous()
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
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad[3:]) if need]
        grads = iter(torch.autograd.grad(out, wanted, grad, allow_unused=True))
        return (None, None, None) + tuple(
            next(grads) if need else None for need in ctx.needs_input_grad[3:]
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
) -> torch.Tensor:
    """Apply the sequential multi-label SPADE modulation chain, fused.

    Arguments as :func:`multispade_modulate_plain`; ``packed`` optionally
    carries the weights already in the kernel's layout (see
    :func:`pack_weights`) so a caller serving many frames packs once.
    """
    L = len(segs)
    return FusedMultiSpade.apply(
        act_name, packed, L, x, ab, *segs, *wshs, *bshs, *wgbs, *bgbs
    )


fused_multispade_modulate.launches = 0
