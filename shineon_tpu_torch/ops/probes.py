"""The repo's Pallas probes as hand-written Hopper kernels (counterparts of
tools/proto_mosaic_caps.py and the ``mmonly`` / ``taps9bf16`` variants of
tools/pallas_conv_probe.py::pallas_conv3x3_int8).

Each probe has a wrapper with the JAX probe's name (``probe_a`` ... ``probe_m``,
``conv_mmonly``, ``conv_taps9bf16``) and a plain PyTorch version beside it
(``<name>_plain``). A wrapper checks device, dtype, shape and contiguity; on a
CUDA tensor it launches one of the four kernel families of ``csrc/probes.cu``
or raises, and on a CPU tensor it computes the plain version. Each launch adds
one to the wrapper's ``launches``; :data:`SPECS` names each layout probe's
family (movement, contraction, chain; the conv variants are the tap-product
family).

The layout probes take the JAX probes' own shapes and dtypes: the shapes are
what each probe tests. The conv variants take any batch, height and width,
with Cin and Cout multiples of 64 (on the card mmonly takes Cin up to
``MMONLY_MAX_CIN``); on the card they read the weight's tap images
(:func:`with_tap_images`, made once per weight) and raise without them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from shineon_tpu_torch.ops.fused_spade import error_ratio
from shineon_tpu_torch.ops.int8_conv import (
    CHANNEL_TILE,  # the tap-product kernels take Cin and Cout in multiples of it too
    INT8_CONV_TOLERANCE,
    QuantizedWeight,
    activation_scale,
    swizzle_128b,
)

KERNEL_SOURCE = "probes"
F32, BF16 = torch.float32, torch.bfloat16
MC_TH = 8  # probe M's row tile


class Spec(NamedTuple):
    """A layout probe: its kernel family, its inputs' and output's (shape,
    dtype), and the line of its ``pl.pallas_call`` in
    tools/proto_mosaic_caps.py."""

    family: str
    inputs: tuple
    out: tuple
    line: int


SPECS = {
    "probe_a": Spec("contraction", (((16, 64, 32), BF16), ((32, 128), BF16)),
                    ((16, 64, 128), BF16), 45),
    "probe_a2": Spec("contraction", (((12, 20, 56), BF16), ((12, 128), BF16)),
                     ((20, 56, 128), F32), 267),
    "probe_b": Spec("movement", (((1600, 128), F32),), ((1600, 128), F32), 63),
    "probe_b2": Spec("movement", (((1600, 128), F32),), ((8, 192, 128), F32), 79),
    "probe_c": Spec("movement", (((12, 4000), BF16),), ((4000, 12), BF16), 96),
    "probe_c2": Spec("movement", (((128, 4000), BF16),), ((4000, 128), BF16), 115),
    "probe_d": Spec("contraction", (((4000, 12), BF16), ((12, 128), BF16)),
                    ((4000, 128), F32), 136),
    "probe_e": Spec("movement", (((16, 192, 64), F32), ((1, 1, 64), F32)),
                    ((16, 192, 64), F32), 152),
    "probe_f": Spec("movement", (((1, 4800), F32),), ((400, 12), F32), 168),
    "probe_g": Spec("movement", (((64, 128), F32),), ((32, 128), F32), 186),
    "probe_h": Spec("movement", (((2, 32, 192, 64), BF16),), ((2, 32, 192, 64), BF16), 212),
    "probe_i": Spec("contraction", (((128, 12), BF16), ((12, 4000), BF16)),
                    ((128, 4000), F32), 240),
    "probe_k": Spec("movement", (((12, 20, 56), F32),), ((12, 20, 48), F32), 282),
    "probe_l": Spec("movement", (((4, 64, 56), F32),), ((2, 4, 16, 56), F32), 299),
    "probe_m": Spec("chain", (((3, 70, 56), BF16), ((9, 3, 128), BF16), ((3, 128, 128), BF16)),
                    ((8, MC_TH, 56, 128), F32), 345),
}
CONV_VARIANTS = ("conv_mmonly", "conv_taps9bf16")  # call at tools/pallas_conv_probe.py:282

# Kernel against plain version (and plain version against the JAX probe on
# the CPU), element by element: |out - ref| <= tol * (|ref| + rms(ref)).
# Movement copies values (the affine ones round a product, then a sum, on
# both sides): exact, tol 0. Contractions sum exact bf16 products in f32 in
# another order: a few f32 ulps of K <= 32 terms, 1e-5; probe A then rounds
# to bf16, where one rounding flipped by such an ulp is 2^-8 of |ref|: 4e-3.
# Probe M rounds its hidden map to bf16 after a sum of 27 products taken in
# another order (a rare flip moves one of the 384 terms of an output by
# 2^-8 of itself) and sums 384 products: 1e-3. The tap products are integer
# sums, exact on both sides, dequantized with the same uncontracted f32
# operations: the int8 conv's bf16 limit.
def _tolerance(spec: Spec) -> float:
    if spec.family == "movement":
        return 0.0
    if spec.family == "chain":
        return 1e-3
    return 4e-3 if spec.out[1] == BF16 else 1e-5


TOLERANCE = {**{name: _tolerance(spec) for name, spec in SPECS.items()},
             **{name: INT8_CONV_TOLERANCE[BF16] for name in CONV_VARIANTS}}


def agrees(name: str, out: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(ok, max |out - ref|, error ratio) of a probe's output against its
    plain version under TOLERANCE[name] (exact equality where it is 0)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        return False, float("inf"), float("inf")
    err = (out.float() - ref.float()).abs().max().item()
    ratio = error_ratio(out, ref)
    tol = TOLERANCE[name]
    ok = torch.equal(out, ref) if tol == 0.0 else (
        bool(torch.isfinite(out.float()).all()) and ratio <= tol)
    return ok, err, ratio


_INPUT_SCALES = {"probe_m": (1.0, 0.3, 0.05)}  # keeps M's hidden map and output near 1


def random_inputs(name: str, seed: int, device="cpu") -> tuple:
    """Seeded normal inputs of a layout probe's shapes and dtypes (random
    values, so a wrong index map, tap or K tail shows)."""
    g = torch.Generator().manual_seed(seed)
    inputs = SPECS[name].inputs
    scales = _INPUT_SCALES.get(name, (1.0,) * len(inputs))
    return tuple((scale * torch.randn(shape, generator=g)).to(dtype).to(device)
                 for (shape, dtype), scale in zip(inputs, scales))


# ------------------------------------------------------------ plain versions

def probe_a_plain(x, w):
    return torch.einsum("hwc,cd->hwd", x.float(), w.float()).to(x.dtype)


def probe_a2_plain(s, w):
    return torch.einsum("chw,cn->hwn", s.float(), w.float())


def probe_b_plain(x):
    return (x.reshape(8, 200, 128) + 1.0).reshape(1600, 128)


def probe_b2_plain(x):
    return x.reshape(8, 200, 128)[:, 4:196].contiguous()


def probe_c_plain(x):
    return x.t().contiguous()


def probe_c2_plain(x):
    return x.t().contiguous()


def probe_d_plain(a, b):
    return a.float() @ b.float()


def probe_e_plain(x, s):
    return x * s[0, 0] + 1.0


def probe_f_plain(x):
    return x[0].reshape(400, 12).clone()


def probe_g_plain(x):
    return torch.cat([x[16 * i + 3:16 * i + 19] for i in range(2)])


def probe_h_plain(x):
    return x * 2.0


def probe_i_plain(a, b):
    return a.float() @ b.float()


def probe_k_plain(x):
    return x[:, :, 3:51].contiguous()


def probe_l_plain(x):
    """The function the JAX probe's ``ref`` states (proto_mosaic_caps.py:306-309);
    its kernel body raises (a (4, 16, 56) value into a (1, 4, 16, 56) block)."""
    return torch.stack([x[:, 8 * i + 3:8 * i + 19] for i in range(2)])


def probe_m_plain(s, wsh, wgb):
    """The JAX probe's body step for step: per grid index i the nine taps of
    the hidden map in f32 (every dj of a row tap contracts the same segmap
    rows: the probe folds no column shift), ReLU, one rounding to bf16, then
    three row-tap products with wgb in f32."""
    sf, wshf, wgbf = s.float(), wsh.float(), wgb.float()
    outs = []
    for i in range((s.shape[1] - 6) // MC_TH):
        seg = sf[:, MC_TH * i:MC_TH * i + MC_TH + 6]
        h = None
        for di in range(3):
            for dj in range(3):
                tap = torch.einsum("crw,cn->rwn", seg[:, di:di + MC_TH + 4], wshf[3 * di + dj])
                h = tap if h is None else h + tap
        h = torch.relu(h).to(BF16).float()
        gb = None
        for di in range(3):
            tap = torch.einsum("rwk,kn->rwn", h[di:di + MC_TH], wgbf[di])
            gb = tap if gb is None else gb + tap
        outs.append(gb)
    return torch.stack(outs)


def conv_mmonly_plain(xp, qw: QuantizedWeight, scale, bias):
    """The centre tap [1:1+H, 1:1+W] of the padded int8 input times every one
    of the nine weight taps (pallas_conv_probe.py:190-203: not a conv, a
    measure of the int8 product rate), summed exactly in float64, then
    ``acc * scale + bias`` in f32 and bf16 out."""
    acc = xp[:, 1:-1, 1:-1].double() @ qw.wq.double().sum(0).t()
    return (acc.float() * scale + bias).to(BF16)


def conv_taps9bf16_plain(xp, qw: QuantizedWeight, scale, bias):
    """The 3x3 conv of the padded int8 input (pallas_conv_probe.py:173-189).
    The kernel takes the int8 values as bf16 operands with f32 sums, which
    are exact integers while every partial sum stays below 2^24; here the
    sums are exact in float64, then ``acc * scale + bias`` in f32, bf16 out."""
    cout, cin = qw.wq.shape[1:]
    w = qw.wq.reshape(3, 3, cout, cin).permute(2, 3, 0, 1).double()
    acc = F.conv2d(xp.double().permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    return (acc.float() * scale + bias).to(BF16)


def quantize_padded(v: torch.Tensor) -> tuple:
    """The conv probe's quantization outside the kernel
    (pallas_conv_probe.py:233-235, 252-253): ``(xp, s)`` with s the
    per-tensor scale ``max |v| / 127 + 1e-30`` and xp (B, H+2, W+2, Cin) the
    int8 levels ``clip(round(v / s), -127, 127)`` with a zero halo. (The TPU
    tool also pads W to a multiple of 8 for its DMA; nothing here needs it.)"""
    s = activation_scale(v)
    vq = torch.clamp(torch.round(v.float() / s), -127, 127).to(torch.int8)
    return F.pad(vq, (0, 0, 1, 1, 1, 1)), s


# ----------------------------------------------- the tap-product images

MMONLY_MAX_CIN = 512  # mmonly's resident hi and lo images and two input tiles fit in shared memory


class TapImages(NamedTuple):
    """The tap-product kernels' weights (:func:`tap_images`), rows 128-byte
    swizzled (``int8_conv.swizzle_128b``). ``hilo`` (2, ceil(Cin / 128),
    Cout, 128) int8, mmonly's: part 0 hi, part 1 lo of :func:`split_tap_sum`;
    chunk c, row n holds input channels 128c .. 128c + 127 of output n, zero
    past Cin. ``bf16`` (Cin / 64, 9, Cout, 64) bf16, taps9bf16's: slice
    (c, tap), row n holds channels 64c .. 64c + 63 of wq[tap, n]."""

    hilo: torch.Tensor
    bf16: torch.Tensor


def split_tap_sum(wq: torch.Tensor) -> tuple:
    """(hi, lo) int8 (Cout, Cin) with S = 128 hi + lo exactly, S the sum of
    the nine taps of ``wq`` in int32 (|S| <= 9 * 127 = 1143): lo = ((S + 64)
    & 127) - 64 in [-64, 63], hi = (S - lo) / 128 in [-9, 9]. mmonly's
    function is the centre tap times S: two int8 products."""
    s = wq.to(torch.int32).sum(0)
    lo = ((s + 64) & 127) - 64
    hi = torch.div(s - lo, 128, rounding_mode="floor")  # exact: s - lo is a multiple of 128
    return hi.to(torch.int8), lo.to(torch.int8)


def tap_images(wq: torch.Tensor) -> TapImages:
    """(9, Cout, Cin) int8 weights, Cin and Cout multiples of 64 -> the
    tap-product kernels' images (:class:`TapImages`)."""
    _, cout, cin = wq.shape
    if cin % CHANNEL_TILE or cout % CHANNEL_TILE:
        raise ValueError(f"tap_images: Cin={cin} and Cout={cout} must be multiples of "
                         f"{CHANNEL_TILE}")
    hi, lo = split_tap_sum(wq)
    nch = -(-cin // 128)
    hilo = wq.new_zeros(2, cout, nch * 128)
    hilo[0, :, :cin] = hi
    hilo[1, :, :cin] = lo
    hilo = hilo.view(2, cout, nch, 128).permute(0, 2, 1, 3)
    wb = wq.to(BF16).view(9, cout, cin // 64, 64).permute(2, 0, 1, 3)
    return TapImages(swizzle_128b(hilo).contiguous(), swizzle_128b(wb).contiguous())


def unpack_tap_images(images: TapImages, cin: int, cout: int) -> tuple:
    """The inverse of :func:`tap_images`: (hi, lo) int8 (Cout, Cin) and the
    (9, Cout, Cin) int8 weights."""
    hilo = swizzle_128b(images.hilo).permute(0, 2, 1, 3).reshape(2, cout, -1)
    wq = swizzle_128b(images.bf16).permute(1, 2, 0, 3).reshape(9, cout, cin)
    return hilo[0, :, :cin], hilo[1, :, :cin], wq.to(torch.int8)


def with_tap_images(qw: QuantizedWeight) -> QuantizedWeight:
    """``qw`` with its tap images (:func:`tap_images`) in ``taps``. Made once
    per weight, outside any timed call: on the card conv_mmonly and
    conv_taps9bf16 read them and raise without them."""
    return qw._replace(taps=tap_images(qw.wq))


# ------------------------------------------------------------ the kernels

def _check(cond: bool, name: str, msg: str):
    if not cond:
        raise ValueError(f"{name}: {msg}")


@functools.lru_cache(maxsize=None)
def _library():
    """The kernels' shared library, built if needed, argument types set once."""
    from shineon_tpu_torch.ops.cuda_build import load_library

    lib = load_library(KERNEL_SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn, args in (
        (lib.probe_gather, [i, p, p, ctypes.POINTER(ctypes.c_uint32), p, f, f, p]),
        (lib.probe_transpose, [p, p, i, i, ctypes.POINTER(i), p]),
        (lib.probe_gemm, [p, p, p] + [i] * 5 + [p]),
        (lib.probe_chain, [p] * 4 + [i] * 3 + [p]),
        (lib.probe_taps, [i] + [p] * 5 + [i] * 5 + [p]),
    ):
        fn.restype = ctypes.c_int
        fn.argtypes = args
    lib.probes_error_string.restype = ctypes.c_char_p
    lib.probes_error_string.argtypes = [ctypes.c_int]
    return lib


def _call(entry: str, *args, device):
    """Call a C entry of the library on ``device``'s current stream; raise
    on a non-zero cudaError_t."""
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, entry)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: "
                           f"{lib.probes_error_string(err).decode()} ({err})")


# ------------------------------------------------- the movement kernel's map

ELEM, VEC, SHIFT = 0, 1, 2  # a gather unit: one element, or 16 bytes aligned or shifted
COPY, SCALE, SCALE_ADD, CHAN_SCALE_ADD = 0, 1, 2, 3  # y = x, a x, a x + b, chan[c] x + b
INDEX_LIMIT = 1 << 31  # the kernels index in 32 bits
MAX_CHANNELS = 512  # channel scales a gather block holds in shared memory


class Map(NamedTuple):
    """A movement probe's output (``shape``, contiguous) as a strided map
    into its first input: y[i] = x[base + i . strides], in elements."""

    shape: tuple
    strides: tuple
    base: int


MAPS = {
    "probe_b": Map((8, 200, 128), (25600, 128, 1), 0),
    "probe_b2": Map((8, 192, 128), (25600, 128, 1), 4 * 128),
    "probe_c": Map((4000, 12), (1, 4000), 0),
    "probe_c2": Map((4000, 128), (1, 4000), 0),
    "probe_e": Map((16, 192, 64), (12288, 64, 1), 0),
    "probe_f": Map((400, 12), (12, 1), 0),
    "probe_g": Map((2, 16, 128), (2048, 128, 1), 3 * 128),
    "probe_h": Map((2, 32, 192, 64), (393216, 12288, 64, 1), 0),
    "probe_k": Map((12, 20, 48), (1120, 56, 1), 3),
    "probe_l": Map((2, 4, 16, 56), (448, 3584, 56, 1), 3 * 56),
}
# each contraction probe's (M, N, K, A given (K, M), output dtype)
CONTRACTIONS = {
    "probe_a": (1024, 128, 32, False, BF16),
    "probe_a2": (1120, 128, 12, True, F32),
    "probe_d": (4000, 128, 12, False, F32),
    "probe_i": (128, 4000, 12, False, F32),
}


def collapse(shape, strides, keep_last=False) -> tuple:
    """(dims, strides) of the same map with dims of size 1 dropped and each
    dim merged into the next inner one where their strides chain (``s[i] ==
    d[i+1] s[i+1]``). ``keep_last`` keeps the last dim apart (the channel
    index of a per-channel scale)."""
    last = len(shape) - 1
    kept = [[d, s] for i, (d, s) in enumerate(zip(shape, strides))
            if d != 1 or (keep_last and i == last)]
    if not kept:
        return (1,), (1,)
    out = [kept[-1]]
    for d, s in reversed(kept[:-1]):
        inner = out[0]
        if s == inner[0] * inner[1] and not (keep_last and len(out) == 1):
            inner[0] *= d
        else:
            out.insert(0, [d, s])
    return tuple(d for d, _ in out), tuple(s for _, s in out)


def magic(d: int) -> tuple:
    """(mul, shr) with ``n // d == (n * mul) >> shr`` for every 0 <= n < 2^31
    and mul < 2^32: shr = 31 + ceil(log2 d), mul = ceil(2^shr / d). The error
    mul d - 2^shr lies in [0, d), so n mul / 2^shr exceeds n / d by less
    than 2^31 d / (d 2^shr) <= 1 / d: never past the next integer."""
    if not 1 <= d < INDEX_LIMIT:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    shr = 31 + (d - 1).bit_length()
    return -(-(1 << shr) // d), shr


class GatherPlan(NamedTuple):
    """The gather kernel's launch: the collapsed map in units (the last dim
    counted in units, its stride the unit's width when a unit is 16
    bytes), the base (aligned down by ``off`` in SHIFT mode) and each dim's
    multiply-shift divisor."""

    dims: tuple
    strides: tuple
    base: int
    off: int
    mode: int
    unit: int
    magic: tuple

    @property
    def units(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n


def gather_plan(shape, strides, base, itemsize, aligned=True, chan=False) -> GatherPlan:
    """Collapse the map, then take 16-byte units where the last dim is
    contiguous, its length a multiple of 16 bytes and every other stride a
    multiple of 16 bytes (``aligned``: both buffers 16-byte aligned): VEC
    where the base is aligned too, SHIFT where every row starts ``off``
    elements past alignment; else one element a unit (ELEM)."""
    if any(s < 0 for s in strides) or base < 0:
        raise ValueError("the map's strides and base must be non-negative")
    dims, st = collapse(shape, strides, keep_last=chan)
    if len(dims) > 4:
        raise ValueError(f"the map collapses to {len(dims)} dims; the kernel takes 4")
    width = 16 // itemsize
    off, mode, unit = 0, ELEM, 1
    if (aligned and st[-1] == 1 and dims[-1] % width == 0
            and all(s % width == 0 for s in st[:-1])):
        off, unit = base % width, width
        mode = SHIFT if off else VEC
        dims, st, base = dims[:-1] + (dims[-1] // width,), st[:-1] + (width,), base - off
    return GatherPlan(dims, st, base, off, mode, unit, tuple(magic(d) for d in dims))


def _plan_words(plan: GatherPlan, affine: int, channels: int):
    pad = 4 - len(plan.dims)
    words = [len(plan.dims), plan.mode, affine, plan.base, plan.off, plan.units, channels,
             *plan.dims, *(1,) * pad, *(m for m, _ in plan.magic), *(1,) * pad,
             *(s for _, s in plan.magic), *(0,) * pad, *plan.strides, *(0,) * pad]
    return (ctypes.c_uint32 * len(words))(*words)


def _gather(x, shape, strides, base, chan=None, a=1.0, b=0.0, affine=COPY, out=None):
    """Family 1: y (shape, contiguous) with y[i] = x[base + i . strides] (up
    to 4 dims), then a y, a y + b or chan[last index] y + b, through the
    collapsed map of :func:`gather_plan`. ``out``: where to write y (else
    a new tensor)."""
    y = torch.empty(shape, dtype=x.dtype, device=x.device) if out is None else out
    top = base + sum((d - 1) * s for d, s in zip(shape, strides))
    if x.numel() >= INDEX_LIMIT or y.numel() >= INDEX_LIMIT or top >= x.numel():
        raise ValueError(f"gather: x of {x.numel()} and y of {y.numel()} elements (each under "
                         f"2^31), the map reads up to {top}")
    if (affine == CHAN_SCALE_ADD) != (chan is not None) or (
            chan is not None and not 1 <= chan.numel() == shape[-1] <= MAX_CHANNELS):
        raise ValueError("gather: a per-channel scale needs CHAN_SCALE_ADD and one scale a "
                         f"last-dim element (at most {MAX_CHANNELS})")
    plan = gather_plan(shape, strides, base, x.element_size(),
                       aligned=x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0,
                       chan=chan is not None)
    _call("probe_gather", int(x.dtype == BF16), x.data_ptr(), y.data_ptr(),
          _plan_words(plan, affine, 0 if chan is None else chan.numel()),
          None if chan is None else chan.data_ptr(), a, b, device=x.device)
    return y


# the transpose kernels' geometry (csrc/probes.cu): transpose8_kernel's
# threads a block (one 8 x 8 block a thread); transpose_cols_kernel's (8
# columns of the 12 rows a thread) and its rows; the slab route's threads a
# block, its rows, elements and columns a slab at most
T8_THREADS = 64
COLS_THREADS, COLS_ROWS = 32, 12
SLAB_THREADS, SLAB_ROWS, SLAB_ELEMS, SLAB_MAX_COLS = 128, 64, 3072, 256
TRANSPOSE_ROUTES = ("tiles", "cols", "slab")  # by the number probe_transpose reports


class TransposePlan(NamedTuple):
    """The transpose's launch: ``route`` "tiles" (transpose8_kernel: R and C
    multiples of 8, both pointers 16-byte aligned, one 8 x 8 block a
    thread, row groups fastest), "cols" (transpose_cols_kernel: R = 12, C a
    multiple of 8, aligned; ``tile`` = (12, 8) a thread) or "slab"
    (transpose_slab_kernel, anything else: slabs of ``tile`` = (TR, TC)
    input rows and columns, one a block, column slabs fastest); ``blocks``
    of ``threads``."""

    route: str
    tile: tuple
    threads: int
    blocks: int


def transpose_plan(R, C, ptrs=(0, 0)) -> TransposePlan:
    """The launch of y (C, R) = x (R, C)^T for x and y at ``ptrs``, as
    csrc/probes.cu::probe_transpose chooses it; raises ValueError for what
    the kernels do not take (R or C below 1, R C of 2^31 or more)."""
    if R < 1 or C < 1 or R * C >= INDEX_LIMIT:
        raise ValueError(f"transpose: R={R} and C={C} must be positive with R*C < 2^31")
    aligned = ptrs[0] % 16 == 0 and ptrs[1] % 16 == 0 and C % 8 == 0
    if aligned and R % 8 == 0:
        return TransposePlan("tiles", (8, 8), T8_THREADS, -(-(R * C // 64) // T8_THREADS))
    if aligned and R == COLS_ROWS:
        return TransposePlan("cols", (R, 8), COLS_THREADS, -(-(C // 8) // COLS_THREADS))
    tr = min(R, SLAB_ROWS)
    tc = min(SLAB_ELEMS // tr, SLAB_MAX_COLS)
    return TransposePlan("slab", (tr, tc), SLAB_THREADS, -(-C // tc) * -(-R // tr))


def transpose_routed(x, out=None):
    """Family 1's transposes: x (R, C) bf16, contiguous -> y (C, R) (written
    to ``out``, contiguous, where given). Returns y and the route (one of
    TRANSPOSE_ROUTES) that the C entry reports it launched."""
    _check(x.dim() == 2 and x.dtype == BF16, "transpose", "x must be (R, C) bf16")
    R, C = x.shape
    transpose_plan(R, C)
    _check(x.is_contiguous(), "transpose", "x must be contiguous")
    y = torch.empty((C, R), dtype=x.dtype, device=x.device) if out is None else out
    _check(tuple(y.shape) == (C, R) and y.dtype == BF16 and y.is_contiguous()
           and y.device == x.device, "transpose",
           f"out must be a contiguous ({C}, {R}) bf16 tensor on {x.device}")
    route = ctypes.c_int(-1)
    _call("probe_transpose", x.data_ptr(), y.data_ptr(), R, C, ctypes.byref(route),
          device=x.device)
    return y, TRANSPOSE_ROUTES[route.value]


def _transpose(x, out=None):
    """Family 1's transposes, by :func:`transpose_routed`: y (C, R) = x^T."""
    return transpose_routed(x, out)[0]


# --------------------------------------------- the contraction kernel's plan

GEMM_TILE = (64, 64)  # (M, N) a block: wgmma's 64 rows (one warpgroup), 64 columns
GEMM_STAGE_K = 64  # K a stage at most: one 128-byte row of bf16
GEMM_FLAT_MAX_K = 256  # a flat A slab: 64 rows of at most 512 bytes
GEMM_ROUTES = ("tma", "tma_t", "flat")  # the C entry's route codes, in order


class GemmPlan(NamedTuple):
    """The contraction kernel's launch. ``a_route``: "tma" (A (M, K), K a
    multiple of 8: K-major boxes), "tma_t" (A given (K, M), M a multiple of
    8: M-major boxes through wgmma's transpose bit) or "flat" (A (M, K) with
    rows off 16 bytes: each block's 64-row slab by one bulk copy, the
    fragments built in registers); ``b_route``: B (K, N) by TMA, MN-major.
    ``bk``: K a stage; ``stages``: 1, or a ring of 2 where K > bk; ``grid``:
    (N tiles, M tiles)."""

    a_route: str
    b_route: str
    tile: tuple
    bk: int
    stages: int
    grid: tuple


def gemm_plan(M, N, K, a_trans, ptrs=(0, 0, 0)) -> GemmPlan:
    """The launch plan of ``(M, N) = A . B`` for operands and output at
    ``ptrs``; raises ValueError for what the kernel does not take: N not a
    multiple of 8 (B's and the output's rows are TMA rows and 16-byte
    stores), A given (K, M) with M not a multiple of 8, A (M, K) with rows
    off 16 bytes and K > GEMM_FLAT_MAX_K, a pointer off 16 bytes."""
    if M < 1 or K < 1 or N < 1:
        raise ValueError(f"gemm: M={M}, N={N}, K={K} must be positive")
    if N % 8:
        raise ValueError(f"gemm: N={N} must be a multiple of 8 (16-byte rows of B and out)")
    if any(p % 16 for p in ptrs):
        raise ValueError("gemm: A, B and out must be 16-byte aligned")
    if a_trans:
        if M % 8:
            raise ValueError(f"gemm: A given (K, M) needs M={M} a multiple of 8 (16-byte rows)")
        route = "tma_t"
    elif K % 8 == 0:
        route = "tma"
    elif K <= GEMM_FLAT_MAX_K:
        route = "flat"
    else:
        raise ValueError(f"gemm: A (M, K) with K={K} off 16-byte rows takes K <= "
                         f"{GEMM_FLAT_MAX_K}")
    bk = min(GEMM_STAGE_K, -(-K // 16) * 16)
    grid = (-(-N // GEMM_TILE[1]), -(-M // GEMM_TILE[0]))
    if grid[1] > 65535:
        raise ValueError(f"gemm: M={M} gives more than 65535 row tiles")
    return GemmPlan(route, "tma", GEMM_TILE, bk, 2 if K > bk else 1, grid)


def _gemm(a, b, M, N, K, a_trans, out_dtype, out=None):
    """Family 2: (M, N) = A . b with b (K, N) and a (M, K), or (K, M) when
    ``a_trans``; bf16 operands, f32 sums, output in ``out_dtype`` (written
    to ``out`` where given)."""
    y = torch.empty((M, N), dtype=out_dtype, device=a.device) if out is None else out
    plan = gemm_plan(M, N, K, a_trans, (a.data_ptr(), b.data_ptr(), y.data_ptr()))
    _call("probe_gemm", a.data_ptr(), b.data_ptr(), y.data_ptr(), M, N, K,
          GEMM_ROUTES.index(plan.a_route), int(out_dtype == BF16), device=a.device)
    return y


CHAIN_STRIP = 8  # columns a block of chain_wgmma: 8 x 8 = 64 output positions
CHAIN_HALF = 64  # output channels a block of chain_wgmma


class ChainPlan(NamedTuple):
    """chain_wgmma's launch: ``grid`` = (channel halves, column strips,
    grid indices); block (nh, a, i) computes output rows 0..7 of grid index
    i at columns ``strip`` a .. + strip - 1 (position 8 r + wl) and channels
    64 nh .. 64 nh + 63, from the ``hidden`` = 80 hidden positions of the
    same columns and hidden rows 0..9 (position 8 hr + wl); tap di's A is
    hidden positions 8 di .. 8 di + 63."""

    grid: tuple
    strip: int
    hidden: int


def chain_plan(G, rows, W2) -> ChainPlan:
    """The launch plan of probe M's chain at G grid indices over a segmap
    of ``rows`` rows and W2 columns; raises ValueError for what the kernel
    does not take: W2 off a multiple of 8 (whole strips, the segmap's rows
    16-byte TMA rows), fewer than 8 G + 4 rows, G outside 1..65535."""
    if not 1 <= G <= 65535:
        raise ValueError(f"chain: G={G} grid indices, 1 to 65535")
    if W2 < CHAIN_STRIP or W2 % CHAIN_STRIP or W2 // CHAIN_STRIP > 65535:
        raise ValueError(f"chain: W2={W2} must be a multiple of {CHAIN_STRIP} (at most 65535 "
                         "strips)")
    if rows < MC_TH * G + 4:
        raise ValueError(f"chain: {rows} segmap rows, {G} grid indices need {MC_TH * G + 4}")
    return ChainPlan((128 // CHAIN_HALF, W2 // CHAIN_STRIP, G), CHAIN_STRIP,
                     (MC_TH + 2) * CHAIN_STRIP)


def _chain(s, wsh, wgb, out=None):
    """Family 3: probe M's chain, s (3, rows, W2), wsh (9, 3, 128), wgb (3,
    128, 128) bf16 -> (G, 8, W2, 128) f32, G = (rows - 6) // 8 as in the
    probe (written to ``out`` where given)."""
    _check(s.dim() == 3 and s.shape[0] == 3 and s.dtype == BF16, "chain",
           "s must be (3, rows, W2) bf16")
    _check(tuple(wsh.shape) == (9, 3, 128) and tuple(wgb.shape) == (3, 128, 128)
           and wsh.dtype == BF16 and wgb.dtype == BF16, "chain",
           "wsh must be (9, 3, 128) and wgb (3, 128, 128) bf16")
    G, rows, W2 = (s.shape[1] - 6) // MC_TH, s.shape[1], s.shape[2]
    chain_plan(G, rows, W2)
    y = torch.empty((G, MC_TH, W2, 128), dtype=F32, device=s.device) if out is None else out
    _check(tuple(y.shape) == (G, MC_TH, W2, 128) and y.dtype == F32 and y.device == s.device,
           "chain", f"out must be ({G}, {MC_TH}, {W2}, 128) f32 on {s.device}")
    _check(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (s, wsh, wgb, y)), "chain",
           "operands and output must be contiguous and 16-byte aligned")
    _call("probe_chain", s.data_ptr(), wsh.data_ptr(), wgb.data_ptr(), y.data_ptr(), G, rows, W2,
          device=s.device)
    return y


def _taps(taps9bf16, xp, qw, scale, bias, out=None):
    """Family 4: the tap products of the padded int8 input from the weight's
    tap images, bf16 out (written to ``out`` where given)."""
    B, Hp, Wp, cin = xp.shape
    cout = qw.wq.shape[1]
    images = qw.taps.bf16 if taps9bf16 else qw.taps.hilo
    y = torch.empty((B, Hp - 2, Wp - 2, cout), dtype=BF16, device=xp.device) if out is None else out
    _call("probe_taps", int(taps9bf16), xp.data_ptr(), images.data_ptr(), scale.data_ptr(),
          bias.data_ptr(), y.data_ptr(), B, Hp - 2, Wp - 2, cin, cout, device=xp.device)
    return y


def _dispatch(wrapper, plain, launch, args):
    """The wrapper's dispatch: the plain version for CPU tensors, else the
    kernel, counted."""
    if args[0].device.type == "cpu":
        return plain(*args)
    out = launch(*args)
    wrapper.launches += 1
    return out


def _probe(wrapper, launch, args):
    """Check a layout probe's arguments against its Spec, then dispatch."""
    name = wrapper.__name__
    spec = SPECS[name]
    _check(len(args) == len(spec.inputs), name, f"takes {len(spec.inputs)} tensors")
    for k, (t, (shape, dtype)) in enumerate(zip(args, spec.inputs)):
        _check(tuple(t.shape) == shape and t.dtype == dtype, name,
               f"input {k} is {tuple(t.shape)} {t.dtype}, the probe takes {shape} {dtype}")
        _check(t.device == args[0].device, name, f"input {k} is on {t.device}")
        _check(t.is_contiguous() and t.data_ptr() % 16 == 0, name,
               f"input {k} must be contiguous and 16-byte aligned")
    return _dispatch(wrapper, plain_version(name), launch, args)


# ------------------------------------------------------------ the wrappers

def probe_a(x, w):
    """Probe A: ``o[h, w, d] = sum_c x[h, w, c] w[c, d]``, f32 sums, bf16 out."""
    return _probe(probe_a, lambda x, w: _gemm(x, w, *CONTRACTIONS["probe_a"]).view(16, 64, 128),
                  (x, w))


def probe_a2(s, w):
    """Probe A2: ``o[h, w, n] = sum_c s[c, h, w] w[c, n]``, the contraction
    over the major dim, f32 out."""
    return _probe(probe_a2, lambda s, w: _gemm(s, w, *CONTRACTIONS["probe_a2"]).view(20, 56, 128),
                  (s, w))


def probe_b(x):
    """Probe B: reshape (1600, 128) -> (8, 200, 128), + 1, reshape back."""
    return _probe(probe_b, lambda x: _gather(x, *MAPS["probe_b"], a=1.0, b=1.0,
                                             affine=SCALE_ADD).view(1600, 128), (x,))


def probe_b2(x):
    """Probe B2: reshape (1600, 128) -> (8, 200, 128), rows 4:196."""
    return _probe(probe_b2, lambda x: _gather(x, *MAPS["probe_b2"]), (x,))


def probe_c(x):
    """Probe C: the 2-D transpose (12, 4000) -> (4000, 12), bf16."""
    return _probe(probe_c, _transpose, (x,))


def probe_c2(x):
    """Probe C2: the 2-D transpose (128, 4000) -> (4000, 128), bf16."""
    return _probe(probe_c2, _transpose, (x,))


def probe_d(a, b):
    """Probe D: (4000, 12) @ (12, 128), K = 12, f32 out."""
    return _probe(probe_d, lambda a, b: _gemm(a, b, *CONTRACTIONS["probe_d"]), (a, b))


def probe_e(x, s):
    """Probe E: ``x * s[c] + 1``, the channel broadcast."""
    return _probe(probe_e, lambda x, s: _gather(x, *MAPS["probe_e"], chan=s, b=1.0,
                                                affine=CHAN_SCALE_ADD), (x, s))


def probe_f(x):
    """Probe F: the lane split (1, 4800) -> (400, 12)."""
    return _probe(probe_f, lambda x: _gather(x, *MAPS["probe_f"]), (x,))


def probe_g(x):
    """Probe G: grid 2, ``o[16i:16i+16] = x[16i+3:16i+19]``."""
    return _probe(probe_g, lambda x: _gather(x, *MAPS["probe_g"]).view(32, 128), (x,))


def probe_h(x):
    """Probe H: (1, 16, 192, 64) blocks on a (2, 2) grid, each times 2."""
    return _probe(probe_h, lambda x: _gather(x, *MAPS["probe_h"], a=2.0, affine=SCALE), (x,))


def probe_i(a, b):
    """Probe I: (128, 12) @ (12, 4000), N = 4000 the minor dim, f32 out."""
    return _probe(probe_i, lambda a, b: _gemm(a, b, *CONTRACTIONS["probe_i"]), (a, b))


def probe_k(x):
    """Probe K: the static unaligned lane slice ``x[:, :, 3:51]``."""
    return _probe(probe_k, lambda x: _gather(x, *MAPS["probe_k"]), (x,))


def probe_l(x):
    """Probe L: grid 2, ``o[i] = x[:, 8i+3:8i+19, :]``."""
    return _probe(probe_l, lambda x: _gather(x, *MAPS["probe_l"]), (x,))


def probe_m(s, wsh, wgb):
    """Probe M: the miniature SPADE chain (see :func:`probe_m_plain`)."""
    return _probe(probe_m, _chain, (s, wsh, wgb))


def _conv_variant(wrapper, plain, taps9bf16, xp, qw, scale, bias):
    name = wrapper.__name__
    _check(xp.dim() == 4 and xp.dtype == torch.int8, name,
           "xp must be (B, H+2, W+2, Cin) int8")
    B, Hp, Wp, cin = xp.shape
    _check(Hp > 2 and Wp > 2, name, "xp has no pixel inside its halo")
    _check(qw.wq.dim() == 3 and qw.wq.shape[0] == 9 and qw.wq.shape[2] == cin
           and qw.wq.dtype == torch.int8, name, f"wq must be (9, Cout, {cin}) int8")
    cout = qw.wq.shape[1]
    _check(cin % CHANNEL_TILE == 0 and cout % CHANNEL_TILE == 0, name,
           f"Cin={cin} and Cout={cout} must be multiples of {CHANNEL_TILE}")
    for label, t in (("scale", scale), ("bias", bias)):
        _check(t.dtype == F32 and tuple(t.shape) == (cout,), name, f"{label} must be f32 (Cout,)")
    operands = [("xp", xp), ("wq", qw.wq), ("scale", scale), ("bias", bias)]
    if xp.device.type != "cpu":
        operands.append(("tap images", _check_tap_images(name, taps9bf16, qw, cin, cout)))
    for label, t in operands:
        _check(t.device == xp.device, name, f"{label} is on {t.device}, xp on {xp.device}")
        _check(t.is_contiguous() and t.data_ptr() % 16 == 0, name,
               f"{label} must be contiguous and 16-byte aligned")
    return _dispatch(wrapper, plain, lambda *a: _taps(taps9bf16, *a), (xp, qw, scale, bias))


def _check_tap_images(name, taps9bf16, qw, cin, cout) -> torch.Tensor:
    """What a conv variant's kernel needs beyond its plain version: the
    weight's tap images of its shape (:func:`with_tap_images`), and for
    mmonly Cin <= MMONLY_MAX_CIN. Returns the images the kernel reads;
    raises ValueError otherwise."""
    _check(taps9bf16 or cin <= MMONLY_MAX_CIN, name,
           f"the kernel takes Cin <= {MMONLY_MAX_CIN}, not {cin}")
    _check(qw.taps is not None, name,
           "the weight has no tap images: make them once with with_tap_images")
    nch = -(-cin // 128)
    want = ((2, nch, cout, 128), torch.int8) if not taps9bf16 else ((cin // 64, 9, cout, 64), BF16)
    images = qw.taps.bf16 if taps9bf16 else qw.taps.hilo
    _check((tuple(images.shape), images.dtype) == want, name,
           f"tap images are {tuple(images.shape)} {images.dtype}, expected {want[0]} {want[1]}")
    return images


def conv_mmonly(xp: torch.Tensor, qw: QuantizedWeight, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """The conv probe's ``mmonly`` variant: the centre tap of the padded int8
    input times all nine weight taps, int32 sums, ``acc * scale + bias``,
    (B, H, W, Cout) bf16. ``scale`` is the activation scale times the
    weight's per-channel scale. The kernel takes it as two int8 products
    with the summed weights' two parts (:func:`split_tap_sum`)."""
    return _conv_variant(conv_mmonly, conv_mmonly_plain, False, xp, qw, scale, bias)


def conv_taps9bf16(xp: torch.Tensor, qw: QuantizedWeight, scale: torch.Tensor,
                   bias: torch.Tensor) -> torch.Tensor:
    """The conv probe's ``taps9bf16`` variant: the 3x3 conv of the padded
    int8 input with the int8 values as bf16 operands and f32 sums,
    ``acc * scale + bias``, (B, H, W, Cout) bf16."""
    return _conv_variant(conv_taps9bf16, conv_taps9bf16_plain, True, xp, qw, scale, bias)


def plain_version(name: str):
    """The plain PyTorch version beside a probe's wrapper."""
    return globals()[f"{name}_plain"]


WRAPPERS = {name: globals()[name] for name in (*SPECS, *CONV_VARIANTS)}
for _wrapper in WRAPPERS.values():
    _wrapper.launches = 0

