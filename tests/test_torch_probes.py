"""The port's probe kernels against the JAX package's Pallas probes on the
CPU: the 15 layout probes of tools/proto_mosaic_caps.py and the mmonly and
taps9bf16 variants of tools/pallas_conv_probe.py::pallas_conv3x3_int8,
each plain version (what the wrapper computes for a CPU tensor) on seeded
inputs made with numpy, against the JAX kernel body replayed in interpret
mode; and the port's two probe tools, shineon_tpu_torch.tools.layout_caps
and conv_probe, on the CPU."""

import functools
import os.path as osp
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from shineon_tpu_torch.ops import int8_conv as ic  # noqa: E402
from shineon_tpu_torch.ops import probes as pr  # noqa: E402
from shineon_tpu_torch.ops.fused_spade import error_ratio  # noqa: E402
from shineon_tpu_torch.tools import conv_probe, layout_caps  # noqa: E402
from tools import pallas_conv_probe as jconv  # noqa: E402
from tools import proto_mosaic_caps as jcaps  # noqa: E402

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
