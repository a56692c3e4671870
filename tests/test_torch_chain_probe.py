"""Probe M's chain kernel (csrc/probes.cu::chain_wgmma) emulated on the host:
its launch plan (ops/probes.py::chain_plan), its tile plan (each block's
strip of columns, its 80 hidden positions, each tap's 64 of them, each
output written once) and its arithmetic in its own order (the reference's
f32 roundings of the hidden map, ReLU and one bf16 rounding, the taps),
against the port's plain version and the JAX probe M in interpret mode;
and the refusals of the chain wrapper before any build."""

import os.path as osp
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from shineon_tpu_torch.ops import probes as pr  # noqa: E402
from tools import proto_mosaic_caps as jcaps  # noqa: E402
from test_torch_networks import one_torch_thread  # noqa: E402, F401 (autouse)


@pytest.fixture(scope="module")
def jax_probe_m():
    """The JAX probe M's (kernel body, pallas_call arguments), recorded by
    running the probe once in interpret mode."""
    real = jcaps.pl.pallas_call
    calls = {}

    def recorder(kernel, **kwargs):
        calls["probe_m"] = (kernel, kwargs)
        return real(kernel, interpret=True, **kwargs)

    jcaps.pl.pallas_call = recorder
    try:
        jcaps.probe_m()
    finally:
        jcaps.pl.pallas_call = real
    return calls["probe_m"]


def chain_emulated(s, wsh, wgb):
    """What chain_wgmma computes, by its own index arithmetic and in its
    order. Block (nh, a, i) stages the segmap's rows 8 i .. 8 i + 11 at its
    strip's columns (every read inside them) and computes its 80 hidden
    positions 8 hr + wl as the taps t = 3 di + dj in order of ((s0 w0 + s1
    w1) + s2 w2), each operation rounded to f32, then ReLU and one rounding
    to bf16; each tap di reads hidden positions 8 di .. 8 di + 63 (inside
    the 80) for the strip's output positions 8 r + wl, which land at output
    row r, column 8 a + wl; every output position and channel is written
    exactly once."""
    _, rows, W2 = s.shape
    G = (rows - 6) // pr.MC_TH
    plan = pr.chain_plan(G, rows, W2)
    halves, strips, _ = plan.grid
    w = wsh.float().reshape(9, 3, 128)
    out = torch.full((G, pr.MC_TH, W2, 128), float("nan"))
    written = torch.zeros(out.shape, dtype=torch.int64)
    pos = torch.arange(plan.hidden)
    hr, wl = pos // plan.strip, pos % plan.strip
    for i in range(G):
        for a in range(strips):
            cols = plan.strip * a + torch.arange(plan.strip)
            seg = s[:, pr.MC_TH * i:pr.MC_TH * i + pr.MC_TH + 4][:, :, cols].float()
            for nh in range(halves):
                h = None
                for t in range(9):
                    di = t // 3
                    assert int(hr.max()) + di < seg.shape[1]
                    s0, s1, s2 = (seg[c, di + hr, wl][:, None] for c in range(3))
                    tap = (s0 * w[t, 0] + s1 * w[t, 1]) + s2 * w[t, 2]
                    h = tap if h is None else h + tap
                h = torch.relu(h).to(torch.bfloat16).float()
                acc = torch.zeros(64, pr.CHAIN_HALF)
                for di in range(3):
                    tap_rows = plan.strip * di + torch.arange(64)
                    assert int(tap_rows.max()) < plan.hidden
                    acc += h[tap_rows] @ wgb[di, :, 64 * nh:64 * (nh + 1)].float()
                r, c = torch.arange(64) // plan.strip, plan.strip * a + torch.arange(64) % plan.strip
                out[i, r, c, 64 * nh:64 * (nh + 1)] = acc
                written[i, r, c, 64 * nh:64 * (nh + 1)] += 1
    assert torch.equal(written, torch.ones_like(written))
    return out


def _inputs(W2, G, seed):
    """Probe M's operands at W2 columns and G grid indices, scaled as
    random_inputs scales them (hidden map and output near 1)."""
    g = torch.Generator().manual_seed(seed)
    s = torch.randn(3, pr.MC_TH * G + 6, W2, generator=g).to(torch.bfloat16)
    wsh = (0.3 * torch.randn(9, 3, 128, generator=g)).to(torch.bfloat16)
    wgb = (0.05 * torch.randn(3, 128, 128, generator=g)).to(torch.bfloat16)
    return s, wsh, wgb


def test_chain_plan_of_probe():
    """At the probe's shapes: 2 channel halves x 7 strips of 8 columns x 8
    grid indices (112 blocks), 80 hidden positions a block."""
    assert tuple(pr.chain_plan(8, 70, 56)) == ((2, 7, 8), 8, 80)
    assert pr.chain_plan(1, 12, 8).grid == (2, 1, 1)


def test_chain_emulated_matches_plain_and_jax(jax_probe_m):
    """The kernel's emulated arithmetic at the probe's shapes on seeded
    inputs, against probe_m_plain and against the JAX probe M's body in
    interpret mode, within TOLERANCE["probe_m"]."""
    s, wsh, wgb = pr.random_inputs("probe_m", 41)
    out = chain_emulated(s, wsh, wgb)
    ok, err, ratio = pr.agrees("probe_m", out, pr.probe_m_plain(s, wsh, wgb))
    assert ok, (err, ratio)
    kernel, kwargs = jax_probe_m
    ref = jcaps.pl.pallas_call(kernel, interpret=True, **kwargs)(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (s, wsh, wgb)))
    ok, err, ratio = pr.agrees("probe_m", out, torch.from_numpy(np.array(ref, np.float32)))
    assert ok, (err, ratio)


@pytest.mark.parametrize("W2,G", [(8, 2), (16, 1), (72, 2)])
def test_chain_emulated_other_widths(W2, G):
    """At other widths the kernel takes (W2 = 8, one strip; 72, nine) the
    tile plan covers the output once and the arithmetic agrees with
    probe_m_plain."""
    s, wsh, wgb = _inputs(W2, G, W2 + G)
    ok, err, ratio = pr.agrees("probe_m", chain_emulated(s, wsh, wgb),
                               pr.probe_m_plain(s, wsh, wgb))
    assert ok, (err, ratio)


def _meta(*tensors):
    return tuple(t.to("meta") for t in tensors)


def test_chain_refuses_before_dispatch():
    """chain_plan and the chain wrapper refuse what the kernel does not
    take (W2 off a multiple of 8, too few rows, operands of other shapes or
    dtypes) on meta tensors, before any build or launch."""
    with pytest.raises(ValueError, match="W2=60"):
        pr.chain_plan(8, 70, 60)
    with pytest.raises(ValueError, match="W2=4"):
        pr.chain_plan(8, 70, 4)
    with pytest.raises(ValueError, match="segmap rows"):
        pr.chain_plan(8, 60, 56)
    with pytest.raises(ValueError, match="G=0"):
        pr.chain_plan(0, 70, 56)
    s, wsh, wgb = pr.random_inputs("probe_m", 3)
    before = pr.probe_m.launches
    with pytest.raises(ValueError, match="W2=60"):
        pr._chain(*_meta(torch.zeros(3, 70, 60, dtype=torch.bfloat16), wsh, wgb))
    with pytest.raises(ValueError, match="wgb"):
        pr._chain(*_meta(s, wsh, wgb[:, :64]))
    with pytest.raises(ValueError, match="bf16"):
        pr._chain(*_meta(s.float(), wsh, wgb))
    with pytest.raises(ValueError, match="probe_m: input 0"):
        pr.probe_m(*_meta(s[:, :, :48].contiguous(), wsh, wgb))
    assert pr.probe_m.launches == before


# outputs the chain wrapper refuses for probe M's (8, 8, 56, 128) f32: another
# shape, another dtype, a view that is not contiguous
CHAIN_BAD_OUTS = {
    "shape": lambda: torch.empty((8, 8, 48, 128), device="meta"),
    "dtype": lambda: torch.empty((8, 8, 56, 128), dtype=torch.bfloat16, device="meta"),
    "layout": lambda: torch.empty((8, 8, 128, 56), device="meta").transpose(2, 3),
}


@pytest.mark.parametrize("bad", sorted(CHAIN_BAD_OUTS))
def test_chain_refuses_bad_out(bad):
    """The chain wrapper refuses, on meta tensors and before any build, an
    ``out`` the kernel would write past or misread."""
    args = _meta(*pr.random_inputs("probe_m", 3))
    with pytest.raises(ValueError, match="out must be|output must be"):
        pr._chain(*args, out=CHAIN_BAD_OUTS[bad]())
