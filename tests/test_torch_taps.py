"""The conv probe's tap-product kernels (csrc/probes.cu, family 4) on the
CPU: their weight images, the arithmetic of mmonly's two int8 products and
the index arithmetic of both kernels' tiles, emulated on the host and held
against the plain versions and the JAX probe; and the checks the wrappers
make before a launch."""

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
from tools import pallas_conv_probe as jconv  # noqa: E402
from test_torch_networks import one_torch_thread  # noqa: E402, F401 (autouse)

CONV_SHAPE = (2, 16, 8, 64, 128)  # (B, H, W, Cin, Cout), a row tile of 8 in JAX


def _operands(shape, seed):
    """(xp, qw with tap images, scale, bias) of the conv probe, quantized by
    the port's own code from seeded normal values."""
    B, H, W, cin, cout = shape
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((B, H, W, cin), generator=g)
    qw = pr.with_tap_images(ic.quantize_weight(0.05 * torch.randn((cout, cin, 3, 3), generator=g)))
    xp, s = pr.quantize_padded(v)
    return xp, qw, (s * qw.scale).contiguous(), 0.1 * torch.randn((cout,), generator=g)


def _two_products(xp, qw, scale, bias):
    """mmonly's kernel arithmetic in int64: acc = xc . hi, acc *= 128, acc +=
    xc . lo (xc the centre tap), then the kernel's f32 epilogue and bf16."""
    hi, lo = pr.split_tap_sum(qw.wq)
    xc = xp[:, 1:-1, 1:-1].long()
    acc = (xc @ hi.long().t()) * 128 + xc @ lo.long().t()
    assert acc.abs().max() < 2 ** 31  # every sum the kernel takes fits in int32
    return (acc.float() * scale + bias).to(torch.bfloat16)


@settings(max_examples=60, deadline=None)
@given(st.integers(1, 4), st.integers(1, 4), st.integers(0, 2 ** 31 - 1),
       st.sampled_from(["random", "max", "min", "alternate"]))
def test_split_tap_sum_is_exact(cout, cin, seed, kind):
    """hi and lo rebuild the nine taps' int32 sum exactly, lo in [-64, 63] and
    hi in [-9, 9], for int8 weights in [-127, 127], including +-127 at every
    tap (the sums +-1143)."""
    rng = np.random.RandomState(seed % (2 ** 32))
    wq = {"random": rng.randint(-127, 128, (9, cout, cin)),
          "max": np.full((9, cout, cin), 127), "min": np.full((9, cout, cin), -127),
          "alternate": np.where(rng.rand(9, cout, cin) < 0.5, 127, -127)}[kind]
    wq = torch.from_numpy(wq.astype(np.int8))
    hi, lo = pr.split_tap_sum(wq)
    assert hi.dtype == lo.dtype == torch.int8
    assert int(lo.min()) >= -64 and int(lo.max()) <= 63
    assert int(hi.min()) >= -9 and int(hi.max()) <= 9
    assert torch.equal(128 * hi.int() + lo.int(), wq.int().sum(0))


def test_split_tap_sum_extremes():
    """Every sum from -1143 to 1143 splits exactly and in range."""
    s = torch.arange(-1143, 1144, dtype=torch.int32)
    wq = torch.zeros((9, 1, s.numel()), dtype=torch.int8)
    rest = s.clone()
    for t in range(9):  # nine int8 taps that add up to s
        part = rest.clamp(-127, 127)
        wq[t, 0] = part.to(torch.int8)
        rest -= part
    assert not rest.any()
    hi, lo = pr.split_tap_sum(wq)
    assert torch.equal(128 * hi[0].int() + lo[0].int(), s)
    assert int(hi.abs().max()) == 9 and int(lo.min()) == -64 and int(lo.max()) == 63


@pytest.mark.parametrize("shape", [CONV_SHAPE, (1, 5, 7, 192, 64), (3, 3, 4, 128, 256)])
def test_two_products_equal_mmonly_plain(shape):
    """The two-product route, emulated in int64, equals conv_mmonly_plain (the
    centre tap times all nine taps, summed in float64) bit for bit, and so
    does the wrapper on CPU tensors (which launches nothing)."""
    args = _operands(shape, 11)
    out = _two_products(*args)
    before = pr.conv_mmonly.launches
    assert torch.equal(out, pr.conv_mmonly_plain(*args))
    assert torch.equal(out, pr.conv_mmonly(*args))
    assert pr.conv_mmonly.launches == before


def test_two_products_agree_with_jax_mmonly():
    """The two-product route against the JAX probe's mmonly variant
    (pallas_conv3x3_int8 in interpret mode, a row tile of 8) on the same f32
    input, within the variant's tolerance, as the plain version is held."""
    B, H, W, cin, cout = CONV_SHAPE
    rng = np.random.RandomState(7)
    v = rng.randn(B, H, W, cin).astype(np.float32)
    k = (0.05 * rng.randn(3, 3, cin, cout)).astype(np.float32)  # HWIO, the JAX layout
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    real = jconv.pl.pallas_call
    jconv.pl.pallas_call = functools.partial(real, interpret=True)
    try:
        ref = jconv.pallas_conv3x3_int8(jnp.asarray(v), jnp.asarray(k), jnp.asarray(b),
                                        jnp.bfloat16, th=8, variant="mmonly")
    finally:
        jconv.pl.pallas_call = real
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32))).to(torch.bfloat16)
    qw = ic.quantize_weight(torch.from_numpy(k).permute(3, 2, 0, 1))
    xp, s = pr.quantize_padded(torch.from_numpy(v))
    out = _two_products(xp, qw, (s * qw.scale).contiguous(), torch.from_numpy(b))
    assert out.shape == ref.shape
    assert error_ratio(out, ref) <= pr.TOLERANCE["conv_mmonly"]


@pytest.mark.parametrize("cin,cout", [(64, 64), (64, 128), (128, 256), (192, 192), (320, 64)])
def test_tap_images_unpack_to_wq(cin, cout):
    """Both images of a weight unpack exactly: the bf16 slice images to wq,
    mmonly's to the two parts of the summed weights; every byte past Cin is
    zero, and the images have the shapes the kernels read."""
    qw = ic.quantize_weight(torch.randn(cout, cin, 3, 3))
    images = pr.tap_images(qw.wq)
    nch = -(-cin // 128)
    assert images.hilo.shape == (2, nch, cout, 128) and images.hilo.dtype == torch.int8
    assert images.bf16.shape == (cin // 64, 9, cout, 64) and images.bf16.dtype == torch.bfloat16
    hi, lo, wq = pr.unpack_tap_images(images, cin, cout)
    assert torch.equal(wq, qw.wq)
    want_hi, want_lo = pr.split_tap_sum(qw.wq)
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    assert images.hilo.abs().sum() == hi.abs().sum() + lo.abs().sum()
    assert pr.with_tap_images(qw).taps.bf16.equal(images.bf16)


def _taps9_plan(H, W):
    """taps9_wgmma's geometry (csrc/probes.cu: plan_taps9): bands of at most
    64 columns as even as W allows, the padded band width WT, the input rows
    staged for an item of 128 flat positions, the items a band."""
    nb = -(-W // 64)
    WT = -(-W // nb) + 2
    TW = WT - 2
    nrows = (WT - 1 + 128 + 2 * WT + 2 + WT - 1) // WT
    return TW, WT, -(-W // TW), nrows, -(-(H * WT) // 128)


def _taps9_emulated(xp, wq):
    """The int32 sums taps9_wgmma computes, by its own index arithmetic: for
    each band and item, the staged rows r_lo .. r_lo + nrows - 1 of the
    band's padded columns (zero past the input), then for each of the
    item's 128 flat positions P = r WT + c and each tap the staged row
    P - r_lo WT + di WT + dj, which must lie inside the staged rows; outputs
    whose column is a halo column or past the image are dropped."""
    B, Hp, Wp, cin = xp.shape
    H, W = Hp - 2, Wp - 2
    TW, WT, bands, nrows, tiles = _taps9_plan(H, W)
    out = torch.full((B, H, W, wq.shape[1]), -(2 ** 40), dtype=torch.int64)
    x = xp.long()
    w = wq.long()
    for band in range(bands):
        cols = torch.zeros((B, Hp + nrows + 2, WT, cin), dtype=torch.int64)
        part = x[:, :, band * TW:band * TW + WT]
        cols[:, :Hp, :part.shape[2]] = part
        for tile in range(tiles):
            P0 = tile * 128
            r_lo = P0 // WT
            staged = cols[:, r_lo:r_lo + nrows].reshape(B, nrows * WT, cin)
            for p in range(128):
                P = P0 + p
                r, c = divmod(P, WT)
                acc = 0
                for tap in range(9):
                    row = P - r_lo * WT + (tap // 3) * WT + tap % 3
                    assert row < nrows * WT
                    acc = acc + staged[:, row] @ w[tap].t()
                if r < H and c < TW and band * TW + c < W:
                    out[:, r, band * TW + c] = acc
    return out


@pytest.mark.parametrize("shape", [(2, 17, 23, 64, 64), (1, 1, 1, 64, 64), (1, 5, 130, 64, 64),
                                   (2, 9, 70, 128, 64)])
def test_taps9_positions_cover_the_conv(shape):
    """taps9_wgmma's flat positions, emulated by its own index arithmetic
    (bands, padded width, staged rows, tap offsets, the store mask), give
    every output pixel once, each the exact int32 sum of the 3x3 conv that
    conv_taps9bf16_plain takes in float64."""
    B, H, W, cin, cout = shape
    g = torch.Generator().manual_seed(5)
    xp = torch.nn.functional.pad(torch.randint(-127, 128, (B, H, W, cin), generator=g),
                                 (0, 0, 1, 1, 1, 1)).to(torch.int8)
    wq = torch.randint(-127, 128, (9, cout, cin), generator=g).to(torch.int8)
    w = wq.reshape(3, 3, cout, cin).permute(2, 3, 0, 1).double()
    ref = torch.nn.functional.conv2d(xp.double().permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    assert torch.equal(_taps9_emulated(xp, wq), ref.long())


@pytest.mark.parametrize("H,W", [(17, 23), (1, 1), (64, 200), (5, 37), (9, 130), (3, 8)])
def test_mmonly_tiles_cover_each_pixel_once(H, W):
    """mmonly_wgmma's tiles (csrc/probes.cu: plan_mmonly): TW x TH boxes, TW
    the smallest of 8, 16, 32, 64 at least W (64 beyond), each warpgroup
    rows wg TH / 2 .. (wg + 1) TH / 2 - 1 and its pixel p at (p >> log2 TW,
    p & (TW - 1)); with the store mask every pixel is written exactly once."""
    TW = 64 if W > 32 else 32 if W > 16 else 16 if W > 8 else 8
    TH = 128 // TW
    seen = torch.zeros((H, W), dtype=torch.int64)
    for rt in range(-(-H // TH)):
        for band in range(-(-W // TW)):
            for wg in range(2):
                for p in range(64 * wg, 64 * wg + 64):
                    r, c = rt * TH + (p >> (TW.bit_length() - 1)), band * TW + (p & (TW - 1))
                    assert r < rt * TH + TH and (p // 64 == wg)
                    if r < H and c < W:
                        seen[r, c] += 1
    assert torch.equal(seen, torch.ones_like(seen))


def _meta(*args):
    return tuple(a.to("meta") for a in args)


@pytest.mark.parametrize("name", pr.CONV_VARIANTS)
def test_kernel_checks_refuse_before_dispatch(name):
    """On a non-CPU tensor (here the meta device, which reaches the kernel's
    checks but can launch nothing) a conv variant refuses, before any build
    or launch, a weight without tap images, images of another weight's
    shape, and for mmonly Cin above MMONLY_MAX_CIN. On the CPU none of this
    is needed: the plain version runs."""
    wrapper = pr.WRAPPERS[name]
    xp, qw, scale, bias = _operands((1, 4, 6, 64, 128), 3)
    before = wrapper.launches
    bare = qw._replace(taps=None)
    wrapper(xp, bare, scale, bias)  # CPU: no images needed
    with pytest.raises(ValueError, match="no tap images"):
        wrapper(*_meta(xp), ic.QuantizedWeight(*_meta(qw.wq, qw.scale)), *_meta(scale, bias))
    other = pr.tap_images(ic.quantize_weight(torch.randn(64, 64, 3, 3)).wq)
    wrong = ic.QuantizedWeight(*_meta(qw.wq, qw.scale), taps=pr.TapImages(*_meta(*other)))
    with pytest.raises(ValueError, match="tap images are"):
        wrapper(*_meta(xp), wrong, *_meta(scale, bias))
    if name == "conv_mmonly":
        wide = ic.quantize_weight(torch.randn(64, 576, 3, 3))
        wide = wide._replace(taps=pr.TapImages(*_meta(*pr.tap_images(wide.wq))))
        xw = torch.zeros((1, 4, 4, 576), dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="Cin <= 512"):
            wrapper(xw, ic.QuantizedWeight(*_meta(wide.wq, wide.scale), taps=wide.taps),
                    *_meta(torch.ones(64), torch.zeros(64)))
    assert wrapper.launches == before
    with pytest.raises(ValueError, match="multiples of 64"):
        pr.tap_images(torch.zeros((9, 64, 96), dtype=torch.int8))
