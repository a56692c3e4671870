"""SAGAN self-attention, softmax(Q K^T) V with unscaled scores (counterpart
of shineon_tpu/ops/fused_attention.py).

* :func:`attention_plain` is the plain PyTorch version, step for step the
  JAX package's ``_attention_reference``: f32 scores from the input dtype,
  an f32 softmax over the keys, probabilities cast to the input dtype, the
  PV product summed in f32, the output in the input dtype. There is no
  1/sqrt(d): SAGAN takes raw dot products.
* :func:`sagan_attention` is the wrapper. It takes q, k (B, N, d) and v
  (B, N, dv), the JAX layout. On a CUDA tensor it launches the hand-written
  kernel of ``csrc/sagan_attention.cu`` at any N, d and dv (the bf16 kernel
  reads q, k and v by tensor-map copies, whose rows must be 16-byte
  multiples: d and dv are zero-padded here to multiples of 8, exactly: zero
  features add nothing to a score and zero value columns are dropped), or
  raises; on a CPU tensor it computes the plain version. Each launch adds
  one to ``sagan_attention.launches``.
* Gradients go through :class:`SaganAttention`, whose backward recomputes
  in f32 as the JAX package's ``_bwd`` does (serving never needs it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

KERNEL_SOURCE = "sagan_attention"
ROW_STEP = 8  # the bf16 kernel takes d and dv in multiples of this (16-byte rows)
# value columns a bf16 block owns (csrc/sagan_attention.cu: BLOCK_COLS): each
# block computes its queries' scores, so the QK^T work is ceil(dv / this)
# times the minimum
BLOCK_COLS = 512

# Kernel against plain version, element by element: |kernel - plain| <=
# tol * (|plain| + rms(plain)). In f32 the two differ only in the order of
# the sums and in when the softmax is normalised (the kernel divides the
# f32 PV sum by the row sum at the end, the plain version each probability
# first). In bf16 both round the probabilities to bf16 before the PV
# product, but the kernel rounds exp(s - running max) before normalising
# and the plain version the normalised probability, and each rounds its
# own output: the two can sit a bf16 ulp of the output apart (2^-8 of
# |plain|) plus the spread of the probability roundings. A kernel that
# scales the scores by 1/sqrt(d), or normalises over the query axis, reads
# far beyond the limit at peaked rows (chip_smoke.py phase 3d holds both
# controls to fail it).
ATTENTION_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 0.03}


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v over the keys, (B, N, d) x (B, N, d) x (B, N, dv) ->
    (B, N, dv) in q's dtype."""
    energy = torch.bmm(q.float(), k.float().transpose(1, 2))
    attn = torch.softmax(energy, dim=-1).to(q.dtype)
    return torch.bmm(attn.float(), v.float()).to(q.dtype)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"sagan_attention: {msg}")


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel's shared library, built if needed, argument types set once."""
    from shineon_tpu_torch.ops.cuda_build import load_library

    lib = load_library(KERNEL_SOURCE)
    fn = lib.sagan_attention_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.sagan_attention_error_string.restype = ctypes.c_char_p
    lib.sagan_attention_error_string.argtypes = [ctypes.c_int]
    lib.sagan_attention_block_cols.restype = ctypes.c_int
    lib.sagan_attention_block_cols.argtypes = []
    return lib


def _pad_last(t: torch.Tensor, step: int) -> torch.Tensor:
    """t zero-padded on its last dimension to a multiple of step."""
    extra = -t.shape[-1] % step
    return torch.nn.functional.pad(t, (0, extra)) if extra else t


def _launch(q, k, v) -> torch.Tensor:
    """Validate and launch the CUDA kernel on the current stream."""
    _check(q.dim() == 3 and k.dim() == 3 and v.dim() == 3, "q, k, v must be (B, N, d|dv)")
    B, N, d = q.shape
    dv = v.shape[-1]
    _check(tuple(k.shape) == (B, N, d), f"k has shape {tuple(k.shape)}, expected {(B, N, d)}")
    _check(tuple(v.shape[:2]) == (B, N), f"v has shape {tuple(v.shape)}, expected ({B}, {N}, dv)")
    _check(q.dtype in (torch.float32, torch.bfloat16), f"dtype {q.dtype} not supported")
    _check(N >= 1 and d >= 1 and dv >= 1, f"empty shape (N={N}, d={d}, dv={dv})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(t.dtype == q.dtype, f"{name} is {t.dtype}, q is {q.dtype}")
        _check(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")

    if q.dtype == torch.bfloat16:
        q, k, v = (_pad_last(t, ROW_STEP) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    dp, dvp = q.shape[-1], v.shape[-1]
    lib = _library()
    o = torch.empty((B, N, dvp), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.sagan_attention_forward(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, N, dp, dvp, stream)
    if err != 0:
        msg = lib.sagan_attention_error_string(err).decode()
        raise RuntimeError(f"sagan_attention kernel launch failed: {msg} ({err})")
    sagan_attention.launches += 1
    return o if dvp == dv else o[..., :dv].contiguous()


class SaganAttention(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU). Backward: the
    softmax-attention VJP recomputed in f32, like the JAX package's
    ``_bwd``; the gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return attention_plain(q, k, v)
        return _launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
        attn = torch.softmax(torch.bmm(qf, kf.transpose(1, 2)), dim=-1)
        dv = torch.bmm(attn.transpose(1, 2), gf)
        dattn = torch.bmm(gf, vf.transpose(1, 2))
        dscores = attn * (dattn - (dattn * attn).sum(dim=-1, keepdim=True))
        dq = torch.bmm(dscores, kf)
        dk = torch.bmm(dscores.transpose(1, 2), qf)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def sagan_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T) v, unscaled: q, k (B, N, d), v (B, N, dv) -> (B, N, dv)
    in q's dtype."""
    return SaganAttention.apply(q, k, v)


sagan_attention.launches = 0
