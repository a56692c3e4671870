"""The port's probe kernels against the JAX package's Pallas probes on the
CPU: the 15 layout probes of tools/proto_mosaic_caps.py and the mmonly and
taps9bf16 variants of tools/pallas_conv_probe.py::pallas_conv3x3_int8,
each plain version (what the wrapper computes for a CPU tensor) on seeded
inputs made with numpy, against the JAX kernel body replayed in interpret
mode; the port's two probe tools, shineon_tpu_torch.tools.layout_caps
and conv_probe, on the CPU; and the kernels' host plans: the movement
kernel's collapsed maps and multiply-shift divisors against numpy's index
arithmetic, the contraction kernel's launch plan and its refusals, and the
transposes' three routes emulated by their own index arithmetic."""

import functools
import os.path as osp
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from shineon_tpu_torch.ops import int8_conv as ic  # noqa: E402
from shineon_tpu_torch.ops import probes as pr  # noqa: E402
from shineon_tpu_torch.ops.fused_spade import error_ratio  # noqa: E402
from shineon_tpu_torch.tools import conv_probe, layout_caps  # noqa: E402
from tools import pallas_conv_probe as jconv  # noqa: E402
from tools import proto_mosaic_caps as jcaps  # noqa: E402
from test_torch_networks import one_torch_thread  # noqa: E402, F401 (autouse)

# Against JAX, the limits of pr.TOLERANCE hold but one: XLA on the CPU
# contracts probe E's x * s + 1 into one fused multiply-add (one rounding),
# where the port (kernel and plain version alike) rounds the product and then
# the sum; the two differ by an f32 ulp of the product (measured 9.6e-8).
JAX_TOLERANCE = {**pr.TOLERANCE, "probe_e": 1e-6}
CONV_SHAPE = (2, 16, 8, 64, 128)  # (B, H, W, Cin, Cout), a row tile of 8 in JAX


@pytest.fixture(scope="module")
def recorded():
    """Each JAX layout probe's (kernel body, pallas_call arguments), recorded
    by calling the probe once with pl.pallas_call replaced by a recorder that
    runs the real call in interpret mode (the module defines all 15 probes on
    import, A2, K, L and M after its __main__ block)."""
    real = jcaps.pl.pallas_call
    calls = {}
    current = []

    def recorder(kernel, **kwargs):
        calls[current[-1]] = (kernel, kwargs)
        return real(kernel, interpret=True, **kwargs)

    jcaps.pl.pallas_call = recorder
    try:
        for name in pr.SPECS:
            current.append(name)
            getattr(jcaps, name)()  # the probe prints OK, or FAIL for L's body
    finally:
        jcaps.pl.pallas_call = real
    return calls


def _seeded(name, seed):
    """numpy inputs of a layout probe's shapes, exact in its dtypes, and the
    same values as torch tensors."""
    rng = np.random.RandomState(seed)
    arrays, tensors = [], []
    for shape, dtype in pr.SPECS[name].inputs:
        t = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype)
        arrays.append(t.float().numpy())
        tensors.append(t)
    return arrays, tensors


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


def _conv_inputs(seed):
    B, H, W, cin, cout = CONV_SHAPE
    rng = np.random.RandomState(seed)
    v = rng.randn(B, H, W, cin).astype(np.float32)
    k = (0.05 * rng.randn(3, 3, cin, cout)).astype(np.float32)  # HWIO, the JAX layout
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    return v, k, b


def _port_conv(name, v, k, b):
    """The port's conv variant on the CPU, quantized by the port's own code."""
    qw = ic.quantize_weight(torch.from_numpy(k).permute(3, 2, 0, 1))
    xp, s = pr.quantize_padded(torch.from_numpy(v))
    before = pr.WRAPPERS[name].launches
    out = pr.WRAPPERS[name](xp, qw, (s * qw.scale).contiguous(), torch.from_numpy(b))
    assert pr.WRAPPERS[name].launches == before  # a CPU tensor takes the plain version
    return out


@pytest.mark.parametrize("name", [*pr.SPECS, *pr.CONV_VARIANTS])
def test_probe_plain_matches_jax(name, recorded):
    """Each probe's plain version (the wrapper on CPU tensors) against the
    JAX probe on seeded inputs, element by element: exact for movement and
    transposes, JAX_TOLERANCE for the rest. The layout probes replay their
    recorded Pallas body in interpret mode; L's body raises in JAX (a
    (4, 16, 56) value into a (1, 4, 16, 56) block), so L is held to the numpy
    function of its own check (proto_mosaic_caps.py:306-309). The conv
    variants run pallas_conv3x3_int8 itself in interpret mode, at a row tile
    of 8, on the same f32 input, with the port quantizing by its own code."""
    if name in pr.CONV_VARIANTS:
        v, k, b = _conv_inputs(7)
        variant = name[len("conv_"):]
        jconv.pl.pallas_call, real = (functools.partial(jconv.pl.pallas_call, interpret=True),
                                      jconv.pl.pallas_call)
        try:
            ref = jconv.pallas_conv3x3_int8(jnp.asarray(v), jnp.asarray(k), jnp.asarray(b),
                                            jnp.bfloat16, th=8, variant=variant)
        finally:
            jconv.pl.pallas_call = real
        out = _port_conv(name, v, k, b)
    else:
        arrays, tensors = _seeded(name, 100 + list(pr.SPECS).index(name))
        before = pr.WRAPPERS[name].launches
        out = pr.WRAPPERS[name](*tensors)
        assert pr.WRAPPERS[name].launches == before
        assert torch.equal(out, pr.plain_version(name)(*tensors))
        if name == "probe_l":
            x = arrays[0]
            ref = np.stack([x[:, 3:19], x[:, 11:27]])
        else:
            kernel, kwargs = recorded[name]
            real = jcaps.pl.pallas_call
            ref = real(kernel, interpret=True, **kwargs)(
                *(_jax(a, dtype) for a, (_, dtype) in zip(arrays, pr.SPECS[name].inputs)))
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32))).to(out.dtype)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    tol = JAX_TOLERANCE[name]
    if tol == 0.0:
        assert torch.equal(out, ref)
    else:
        assert error_ratio(out, ref) <= tol


def test_mmonly_is_not_the_conv():
    """mmonly computes another function than the conv: against the JAX
    taps9 conv at the same inputs it is far outside the conv limit, while
    taps9bf16's plain version equals the port's plain int8 conv exactly."""
    v, k, b = _conv_inputs(8)
    conv = ic.conv3x3_int8_plain(torch.from_numpy(v), ic.quantize_weight(
        torch.from_numpy(k).permute(3, 2, 0, 1)), torch.from_numpy(b), torch.bfloat16)
    assert torch.equal(_port_conv("conv_taps9bf16", v, k, b), conv)
    assert error_ratio(_port_conv("conv_mmonly", v, k, b), conv) > 100 * pr.TOLERANCE["conv_mmonly"]


def test_layout_caps_main_cpu(capsys):
    """layout_caps on the CPU (the plain versions) prints 15 OK lines and
    returns 0; no kernel is launched."""
    before = {name: fn.launches for name, fn in pr.WRAPPERS.items()}
    assert layout_caps.main(device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("OK   ") for line in lines) == 15
    assert not any(line.startswith("FAIL") for line in lines)
    assert {name: fn.launches for name, fn in pr.WRAPPERS.items()} == before


def test_layout_caps_fails_on_a_broken_probe(monkeypatch, capsys):
    """A probe that computes the wrong thing (K's slice off by one) prints a
    FAIL line, the others still run, and the tool exits 1."""
    monkeypatch.setattr(pr, "probe_k_plain", lambda x: x[:, :, 4:52].contiguous())
    assert layout_caps.main(device="cpu") == 1
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("OK   ") for line in lines) == 14
    assert [line[:7] for line in lines if line.startswith("FAIL")] == ["FAIL K:"]


def test_tools_need_cuda_by_default(capsys):
    """Without an argument both tools run on the card; on a host without
    CUDA they exit 1 instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    assert layout_caps.main() == 1
    assert conv_probe.main(["--variant", "mmonly", "--only", "0", "--iters", "0"]) == 1
    assert capsys.readouterr().err.count("no CUDA device") == 2


@pytest.mark.parametrize("variant", conv_probe.VARIANTS)
def test_conv_probe_variant_cpu(variant):
    """conv_probe's check of each variant on the CPU at a small shape: every
    variant agrees with its reference (the port's plain int8 conv; mmonly its
    own plain version); timing is refused off the card."""
    result = conv_probe.run_variant(variant, (1, 8, 12, 64, 64), "cpu", 0)
    assert result["ok"] and result["ratio"] == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        conv_probe.run_variant(variant, (1, 8, 12, 64, 64), "cpu", 1)


def test_wrappers_validate_before_dispatch():
    """A layout probe takes its own shapes and dtypes only; the conv
    variants take Cin and Cout in multiples of 64 and int8 operands. Both
    raise before computing anything."""
    x = torch.zeros(12, 20, 56)
    with pytest.raises(ValueError, match="probe_k: input 0"):
        pr.probe_k(x[:, :, :50].contiguous())
    with pytest.raises(ValueError, match="probe_k: input 0"):
        pr.probe_k(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        pr.probe_c(torch.zeros(4000, 12, dtype=torch.bfloat16).t())
    qw = ic.quantize_weight(torch.randn(96, 64, 3, 3))
    xp = torch.zeros(1, 6, 6, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="multiples of 64"):
        pr.conv_mmonly(xp, qw, torch.ones(96), torch.zeros(96))
    qw = ic.quantize_weight(torch.randn(64, 64, 3, 3))
    with pytest.raises(ValueError, match="int8"):
        pr.conv_taps9bf16(xp.float(), qw, torch.ones(64), torch.zeros(64))


# ------------------------------------------------------------ host plans

def _itemsize(name):
    return 2 if pr.SPECS[name].inputs[0][1] == torch.bfloat16 else 4


def unit_sources(plan):
    """Each unit's input offset (of its first element, ``plan.off`` before
    it in SHIFT mode) and its index along the last dim, by the gather
    kernel's arithmetic (csrc/probes.cu::unit_source): the digits from the
    multiply-shift divisions, in 64 bits."""
    rest = np.arange(plan.units, dtype=np.uint64)
    src = np.full(plan.units, plan.base, dtype=np.uint64)
    last = rest
    for k in range(len(plan.dims) - 1, 0, -1):
        mul, shr = plan.magic[k]
        q = (rest * np.uint64(mul)) >> np.uint64(shr)
        i = rest - q * np.uint64(plan.dims[k])
        if k == len(plan.dims) - 1:
            last = i
        src += i * np.uint64(plan.strides[k])
        rest = q
    return src + rest * np.uint64(plan.strides[0]), last


def _check_addresses(shape, strides, base, itemsize, chan=False):
    """The plan's units, expanded to their elements, read exactly the input
    elements numpy's strided view gives, in the output's order; with a
    per-channel scale each element's channel is its last-dim index. Returns
    the plan."""
    numel = base + sum((d - 1) * s for d, s in zip(shape, strides)) + 1
    plan = pr.gather_plan(shape, strides, base, itemsize, chan=chan)
    assert plan.units * plan.unit == int(np.prod(shape))
    src, last = unit_sources(plan)
    within = np.arange(plan.unit, dtype=np.uint64)
    got = (src[:, None] + np.uint64(plan.off) + within).reshape(-1)
    flat = np.arange(numel, dtype=np.uint64)[base:]
    want = np.lib.stride_tricks.as_strided(flat, shape, [8 * s for s in strides]).reshape(-1)
    np.testing.assert_array_equal(got, want)
    if chan:
        channel = (last[:, None] * np.uint64(plan.unit) + within).reshape(-1)
        np.testing.assert_array_equal(channel, np.arange(got.size) % shape[-1])
    return plan


# (collapsed dims, unit mode) of each movement probe's map: B, F, G and H
# are one contiguous run (G's two row slices are adjacent), B2 two dims, E
# keeps its channel dim, K (240, 48) at base 3 of 56-float rows, L three
# dims; C and C2 (the transposes) have no contiguous last dim
PROBE_PLANS = {
    "probe_b": ((51200,), pr.VEC), "probe_b2": ((8, 6144), pr.VEC),
    "probe_c": ((4000, 12), pr.ELEM), "probe_c2": ((4000, 128), pr.ELEM),
    "probe_e": ((3072, 16), pr.VEC), "probe_f": ((1200,), pr.VEC),
    "probe_g": ((1024,), pr.VEC), "probe_h": ((98304,), pr.VEC),
    "probe_k": ((240, 12), pr.SHIFT), "probe_l": ((2, 4, 224), pr.VEC),
}


@pytest.mark.parametrize("name", sorted(pr.MAPS))
def test_movement_probe_map_addresses(name):
    """Each of the 10 movement probes: its map, collapsed and in 16-byte
    units where it can be, addresses the elements of numpy's strided view,
    collapses as the kernel's design says, and reads its whole output from
    inside the input."""
    m = pr.MAPS[name]
    plan = _check_addresses(*m, _itemsize(name), chan=name == "probe_e")
    assert (plan.dims, plan.mode) == PROBE_PLANS[name]
    assert m.shape == tuple(pr.SPECS[name].out[0]) or name in ("probe_b", "probe_g")
    assert m.base + sum((d - 1) * s for d, s in zip(*m[:2])) < np.prod(pr.SPECS[name].inputs[0][0])
    if name == "probe_k":
        assert (plan.base, plan.off, plan.strides) == (0, 3, (56, 4))


def _random_map(rng):
    """A strided map of rank 1-4 into a contiguous input: per output dim a
    start, a length and a step of an input dim; often a contiguous last dim
    of 8-element multiples at or off alignment, now and then two dims'
    strides swapped."""
    rank = rng.randint(1, 5)
    dims = list(rng.randint(1, 7, size=rank))
    steps = list(rng.randint(1, 4, size=rank))
    starts = list(rng.randint(0, 5, size=rank))
    if rng.rand() < 0.5:
        dims[-1], steps[-1], starts[-1] = 8 * rng.randint(1, 5), 1, rng.choice([0, 8, 1, 3, 6])
    parent = [int(s + d * st + rng.randint(0, 4)) for s, d, st in zip(starts, dims, steps)]
    parent[-1] = -(-parent[-1] // 8) * 8
    pitch = [1] * rank
    for k in range(rank - 2, -1, -1):
        pitch[k] = pitch[k + 1] * parent[k + 1]
    strides = [int(st * p) for st, p in zip(steps, pitch)]
    if rank > 1 and rng.rand() < 0.2:
        strides[0], strides[-1] = strides[-1], strides[0]
        dims[0] = dims[-1] = min(dims[0], dims[-1])
    base = int(sum(s * p for s, p in zip(starts, pitch)))
    return tuple(int(d) for d in dims), tuple(strides), base


@pytest.mark.parametrize("seed", range(6))
def test_random_map_addresses(seed):
    """Seeded random strided maps of rank 1-4, in f32 and bf16 units, with
    and without a channel dim: the plan addresses what numpy's index
    arithmetic gives, in every unit mode."""
    rng = np.random.RandomState(seed)
    modes = set()
    for _ in range(40):
        shape, strides, base = _random_map(rng)
        for itemsize in (2, 4):
            for chan in (False, True):
                modes.add(_check_addresses(shape, strides, base, itemsize, chan).mode)
    assert modes == {pr.ELEM, pr.VEC, pr.SHIFT}


def test_collapse_merges_chained_strides():
    """Dims whose strides chain merge, size-1 dims drop, keep_last holds the
    last dim apart; an empty map is one element."""
    assert pr.collapse((2, 3, 4), (12, 4, 1)) == ((24,), (1,))
    assert pr.collapse((2, 1, 3, 4), (20, 7, 4, 1)) == ((2, 12), (20, 1))
    assert pr.collapse((2, 3, 4), (12, 4, 1), keep_last=True) == ((6, 4), (4, 1))
    assert pr.collapse((3, 1), (5, 1), keep_last=True) == ((3, 1), (5, 1))
    assert pr.collapse((1, 1), (9, 9)) == ((1,), (1,))
    assert pr.collapse((4, 5), (1, 4)) == ((4, 5), (1, 4))


def _divides(d, n):
    mul, shr = pr.magic(d)
    assert 0 < mul < 1 << 32
    n = np.asarray(n, dtype=np.uint64)
    np.testing.assert_array_equal((n * np.uint64(mul)) >> np.uint64(shr), n // np.uint64(d))


EDGES = np.arange((1 << 31) - 4096, 1 << 31, dtype=np.uint64)


@pytest.mark.parametrize("name", sorted(pr.MAPS))
def test_magic_divisors_at_probe_indices(name):
    """Each divisor of a probe's plan gives // (and so %) over every unit
    index of the probe and at the 4096 indices below 2^31."""
    plan = pr.gather_plan(*pr.MAPS[name], _itemsize(name), chan=name == "probe_e")
    for d in plan.dims:
        _divides(d, np.arange(plan.units, dtype=np.uint64))
        _divides(d, EDGES)


@settings(max_examples=400, deadline=None)
@given(d=st.integers(1, (1 << 31) - 1), n=st.integers(0, (1 << 31) - 1))
def test_magic_divisor_any(d, n):
    """magic(d) gives n // d for any divisor and index under 2^31, and near
    the index's own multiples of d."""
    _divides(d, [n, n - n % d, max(n - n % d - 1, 0), (1 << 31) - 1])


def test_magic_divisor_small_exhaustive():
    """Every divisor up to 2048 against the 4096 indices below 2^31 and the
    first 4096."""
    for d in range(1, 2049):
        _divides(d, EDGES)
        _divides(d, np.arange(4096, dtype=np.uint64))


def test_gather_refuses_2_31_elements():
    """The gather wrapper indexes in 32 bits: an input or output of 2^31
    elements is refused before anything launches (meta tensors, no memory),
    as is a map that reads past its input."""
    x = torch.empty(1 << 31, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        pr._gather(x, (1 << 31,), (1,), 0)
    with pytest.raises(ValueError, match="reads up to"):
        pr._gather(torch.empty(100, device="meta"), (10, 11), (10, 1), 0)
    with pytest.raises(ValueError, match="per-channel"):
        pr._gather(torch.empty(100, device="meta"), (10, 10), (10, 1), 0, affine=pr.CHAN_SCALE_ADD)


# the contraction kernel's plan at each contraction probe: (A's route,
# B's, tile, K a stage, stages, grid as (N tiles, M tiles))
GEMM_PLANS = {
    "probe_a": ("tma", "tma", (64, 64), 32, 1, (2, 16)),
    "probe_a2": ("tma_t", "tma", (64, 64), 16, 1, (2, 18)),
    "probe_d": ("flat", "tma", (64, 64), 16, 1, (2, 63)),
    "probe_i": ("flat", "tma", (64, 64), 16, 1, (63, 2)),
}


@pytest.mark.parametrize("name", sorted(GEMM_PLANS))
def test_gemm_plan_of_probe(name):
    """A (64-byte rows) and A2's (K, M) operand (2240-byte rows) by TMA,
    D's and I's 24-byte rows by the flat slab, B by TMA; all of K in one
    stage; 64 x 64 tiles."""
    M, N, K, a_trans, _ = pr.CONTRACTIONS[name]
    assert tuple(pr.gemm_plan(M, N, K, a_trans, (256, 512, 1024))) == GEMM_PLANS[name]


def test_gemm_plan_refusals_and_ring():
    """Odd N and N off 8, pointers off 16 bytes, A given (K, M) with M off
    8, and A (M, K) with rows off 16 bytes beyond the flat slab's K are
    refused; K beyond a stage runs a ring of two."""
    for N in (127, 6, 4002):
        with pytest.raises(ValueError, match="multiple of 8"):
            pr.gemm_plan(64, N, 16, False)
    for ptrs in ((8, 0, 0), (0, 4, 0), (0, 0, 2)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            pr.gemm_plan(64, 64, 16, False, ptrs)
    with pytest.raises(ValueError, match="M=100"):
        pr.gemm_plan(100, 64, 16, True)
    with pytest.raises(ValueError, match="K=300"):
        pr.gemm_plan(64, 64, 300, False)
    assert pr.gemm_plan(64, 64, 300, True).a_route == "tma_t"
    plan = pr.gemm_plan(200, 72, 144, False)
    assert (plan.a_route, plan.bk, plan.stages) == ("tma", 64, 2)
    assert pr.gemm_plan(200, 72, 100, False)[:5] == ("flat", "tma", (64, 64), 64, 2)
    assert pr.gemm_plan(64, 64, 64, False).stages == 1


# ------------------------------------------------------------ transposes

def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (sel >> 4 i) & 7 of the eight bytes y:x (x's bytes first)."""
    both = np.stack([x, y], -1).astype(np.uint32).view(np.uint8).reshape(*np.shape(x), 8)
    picks = [(sel >> (4 * i)) & 7 for i in range(4)]
    return np.ascontiguousarray(both[..., picks]).view(np.uint32)[..., 0]


def _emulate_tiles(x):
    """transpose8_kernel by its own arithmetic: thread t takes row group
    t % (R / 8) and column group t / (R / 8), loads eight 16-byte rows as
    uint32 words, permutes them (transpose8x8's selectors) and stores eight
    16-byte pieces. Returns (y, writes per output element)."""
    R, C = x.shape
    rgs = R // 8
    t = np.arange(rgs * (C // 8))
    rg, cg = t % rgs, t // rgs
    words = x.view(np.uint32).reshape(R, C // 2)
    # w[t, i, j]: word j of the 16 bytes row 8 rg + i, columns 8 cg ..
    w = words[(8 * rg)[:, None, None] + np.arange(8)[None, :, None],
              (4 * cg)[:, None, None] + np.arange(4)[None, None, :]]
    y = np.zeros((C, R), np.uint16)
    count = np.zeros((C, R), np.int64)
    for k in range(8):
        sel = 0x7632 if k % 2 else 0x5410
        piece = np.stack([byte_perm(w[:, 2 * v, k // 2], w[:, 2 * v + 1, k // 2], sel)
                          for v in range(4)], -1)
        cols = (8 * rg)[:, None] + np.arange(8)[None, :]
        y[(8 * cg + k)[:, None], cols] = piece.view(np.uint16).reshape(-1, 8)
        np.add.at(count, ((8 * cg + k)[:, None], cols), 1)
    return y, count


def _emulate_cols(x):
    """transpose_cols_kernel by its own arithmetic: thread t loads columns
    8 t .. 8 t + 7 of the 12 rows as four uint32 words a row and writes the
    run of 96 output elements from output row 8 t, its word w the byte
    permute of rows r and r + 1 (r = 2 w % 12) at column 2 w / 12."""
    R, C = x.shape
    t = np.arange(C // 8)
    words = x.view(np.uint32).reshape(R, C // 2)
    w = words[np.arange(R)[None, :, None], (4 * t)[:, None, None] + np.arange(4)[None, None, :]]
    y = np.zeros(C * R, np.uint16)
    count = np.zeros(C * R, np.int64)
    for wi in range(4 * R):
        k = 2 * wi
        c, r = k // R, k % R
        word = byte_perm(w[:, r, c // 2], w[:, r + 1, c // 2], 0x7632 if c % 2 else 0x5410)
        at = 8 * t * R + k
        assert np.all(at % 2 == 0)
        y[at], y[at + 1] = word.astype(np.uint32) & 0xFFFF, word.astype(np.uint32) >> 16
        count[at] += 1
        count[at + 1] += 1
    return y.reshape(C, R), count.reshape(C, R)


def _emulate_slab(x, plan):
    """transpose_slab_kernel by its own arithmetic: block b stages rows r0
    .. r0 + tr - 1 and columns c0 .. c0 + tc - 1 of x (column slabs
    fastest) at a row pitch of TC + 1 inside the block's shared tile, then
    writes element (r, c) to output (c0 + c, r0 + r). Returns (y, writes
    per output element)."""
    R, C = x.shape
    TR, TC = plan.tile
    TP = TC + 1
    assert TR * TC <= pr.SLAB_ELEMS and TR <= pr.SLAB_ROWS
    y = np.zeros(C * R, np.uint16)
    count = np.zeros(C * R, np.int64)
    cblocks = -(-C // TC)
    for b in range(plan.blocks):
        c0, r0 = (b % cblocks) * TC, (b // cblocks) * TR
        tr, tc = min(TR, R - r0), min(TC, C - c0)
        tile = np.full(pr.SLAB_ELEMS + pr.SLAB_ROWS, 0xFFFF, np.uint16)
        e = np.arange(tr * tc)
        r, c = e // tc, e % tc
        tile[r * TP + c] = x[r0 + r, c0 + c]
        c, r = e // tr, e % tr
        y[(c0 + c) * R + r0 + r] = tile[r * TP + c]
        np.add.at(count, (c0 + c) * R + r0 + r, 1)
    return y.reshape(C, R), count.reshape(C, R)


# (R, C, x misaligned by an element): the probes (C through 8-column
# groups, C2 through 8 x 8 tiles), one element, a row, a column, R and C off
# every tile edge (8, 64 rows, 48, 236 and 256 columns), aligned shapes that
# the first two routes leave to the slabs (even R other than 12), and
# inputs off 16-byte alignment
TRANSPOSE_CASES = ((12, 4000, 0), (128, 4000, 0), (1, 1, 0), (1, 9, 0), (7, 1, 0),
                   (13, 37, 0), (13, 40, 0), (8, 264, 0), (65, 4000, 0), (65, 4001, 0),
                   (130, 4100, 0), (136, 20, 0), (72, 24, 1), (16, 257, 0), (2, 8, 0),
                   (14, 72, 0), (6, 4008, 0), (12, 4000, 1))


@pytest.mark.parametrize("R,C,shift", TRANSPOSE_CASES)
def test_transpose_plan_covers_output(R, C, shift):
    """The transpose's route at (R, C) for operands at these offsets,
    emulated by its kernel's own arithmetic on seeded bf16 bits: every
    output element is written exactly once, every read lies inside x, and
    the result is x.t() bit for bit."""
    rng = np.random.RandomState(R * C + shift)
    x = rng.randint(0, 1 << 16, size=(R, C)).astype(np.uint16)
    plan = pr.transpose_plan(R, C, (2 * shift, 0))
    aligned = shift == 0 and C % 8 == 0
    want = "tiles" if aligned and R % 8 == 0 else "cols" if aligned and R == 12 else "slab"
    assert plan.route == want
    y, count = {"tiles": _emulate_tiles, "cols": _emulate_cols}.get(
        plan.route, lambda x: _emulate_slab(x, plan))(x)
    np.testing.assert_array_equal(count, 1)
    np.testing.assert_array_equal(y, x.T)


def test_transpose_plan_of_probes():
    """C: 500 threads of 8 columns x 12 rows (16 blocks of 32); C2: 125
    blocks of 64 threads, one 8 x 8 block a thread; a misaligned C the
    slab route's 16 slabs of 12 x 256 (6 KB); the routes are the C entry's
    by number."""
    assert tuple(pr.transpose_plan(12, 4000)) == ("cols", (12, 8), 32, 16)
    assert tuple(pr.transpose_plan(12, 4000, (2, 0))) == ("slab", (12, 256), 128, 16)
    assert tuple(pr.transpose_plan(128, 4000)) == ("tiles", (8, 8), 64, 125)
    assert pr.transpose_plan(130, 4100).tile == (64, 48)
    assert pr.transpose_plan(13, 40).tile == (13, 236)
    assert pr.transpose_plan(128, 4000, (0, 2)).route == "slab"
    assert pr.transpose_plan(14, 72).route == "slab"
    assert pr.TRANSPOSE_ROUTES == ("tiles", "cols", "slab")


# (x, out) pairs the transpose refuses at probe C's (12, 4000): an input view
# that is not contiguous; outputs of another shape, dtype or layout
TRANSPOSE_BAD = {
    "x view": (lambda: torch.empty((4000, 12), dtype=torch.bfloat16, device="meta").t(), None),
    "out shape": (lambda: torch.empty((12, 4000), dtype=torch.bfloat16, device="meta"),
                  lambda: torch.empty((12, 4000), dtype=torch.bfloat16, device="meta")),
    "out dtype": (lambda: torch.empty((12, 4000), dtype=torch.bfloat16, device="meta"),
                  lambda: torch.empty((4000, 12), device="meta")),
    "out layout": (lambda: torch.empty((12, 4000), dtype=torch.bfloat16, device="meta"),
                   lambda: torch.empty((12, 4000), dtype=torch.bfloat16, device="meta").t()),
}


@pytest.mark.parametrize("bad", sorted(TRANSPOSE_BAD))
def test_transpose_refuses_bad_operands(bad):
    """The transpose refuses, on meta tensors and before any build, an
    input or ``out`` its kernels would read or write out of place."""
    x, out = TRANSPOSE_BAD[bad]
    with pytest.raises(ValueError, match="must be contiguous|out must be"):
        pr._transpose(x(), out=out() if out else None)


def test_transpose_refuses_before_dispatch():
    """The transpose refuses, on meta tensors and before any build or
    launch, an operand that is not 2-D bf16 and R C of 2^31 or more."""
    before = pr.probe_c.launches
    with pytest.raises(ValueError, match="R\\*C < 2\\^31"):
        pr._transpose(torch.empty((1 << 16, 1 << 15), dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="\\(R, C\\) bf16"):
        pr._transpose(torch.empty((12, 4000), device="meta"))
    with pytest.raises(ValueError, match="\\(R, C\\) bf16"):
        pr._transpose(torch.empty((2, 12, 4000), dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="R=0"):
        pr.transpose_plan(0, 5)
    with pytest.raises(ValueError, match="probe_c2: input 0"):
        pr.probe_c2(torch.empty((128, 4001), dtype=torch.bfloat16, device="meta"))
    assert pr.probe_c.launches == before
