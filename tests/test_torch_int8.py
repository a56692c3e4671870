"""The port's int8 serving path against the JAX package's on the CPU: the
int8 3x3 conv (ops/int8_conv.py vs spade.py::_conv_same_int8), the
quantized MultiSPADE chain (ops/fused_spade.py vs
multispade_modulate_reference_int8 and the Pallas kernel in interpret
mode), the int8 resblock and generator, and the tiny serving clip with
``int8_spade=True``. Inputs come from a numpy seed and go to both. The
quantization rule on both sides: s = max|v| / 127 + 1e-30 (one scale for
the whole tensor), q = clip(round(v / s), -127, 127), exact integer sums,
y = acc * (s * w_scale[c]) + bias[c] in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _raw_batch, _sams_opt
from shineon_tpu.models.sams_model import SamsModel as JSamsModel
from shineon_tpu.models.warp_model import WarpModel as JWarpModel
from shineon_tpu.networks.sams import SamsGenerator as JSamsGenerator
from shineon_tpu.networks.sams.multispade import MultiSpade as JMultiSpade
from shineon_tpu.networks.sams.spade import SPADE as JSPADE
from shineon_tpu.networks.sams.spade import AnySpadeResBlock as JResBlock
from shineon_tpu.networks.sams.spade import _conv_same_int8
from shineon_tpu.ops import fused_spade as jfs
from shineon_tpu_torch import convert
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.models.warp_model import WarpModel
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.normalization import SpectralConv2d
from shineon_tpu_torch.networks.sams.multispade import MultiSpade
from shineon_tpu_torch.networks.sams.sams_generator import SamsGenerator
from shineon_tpu_torch.networks.sams.spade import SPADE, AnySpadeResBlock, int8_conv_profitable
from shineon_tpu_torch.ops import fused_spade as tfs
from shineon_tpu_torch.ops import int8_conv as ic
from shineon_tpu_torch.options import sams_options, warp_options
from shineon_tpu_torch.serving import make_one_clip, warm_up
from test_torch_fused_spade import _jax_args, _kernel_cols, _make_case, _torch_args
from test_torch_networks import (  # noqa: F401 (one_torch_thread: autouse)
    LABELS,
    _np,
    _spade_inputs,
    _t,
    _with_random_stats,
    one_torch_thread,
)
from test_torch_serving import TINY, _jax_clip


def _int8_env(monkeypatch):
    """The JAX package's int8 serving mode, fused chains, the conv gate
    lowered to the tiny widths."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    monkeypatch.setenv("SHINEON_INT8_SPADE", "1")
    monkeypatch.setenv("SHINEON_INT8_MIN_CH", "8")


def _rel(out, ref):
    """max |out - ref| / max |ref|."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# ------------------------------------------------------------ (a) int8 conv

@pytest.mark.parametrize("shape", [(2, 9, 7, 16, 24), (1, 20, 13, 64, 64), (2, 8, 8, 32, 8),
                                   (1, 5, 3, 128, 64), (1, 6, 5, 32, 96), (1, 6, 5, 96, 32)])
def test_conv3x3_int8_plain_matches_jax(shape):
    """conv3x3_int8_plain (weights quantized by quantize_weight from f32)
    against _conv_same_int8, f32, including ragged spatial shapes:
    |diff| <= 1e-6 * max|ref| at every element. The int32 sums are exact on
    both sides; only the f32 dequantization may differ by an ulp."""
    B, H, W, cin, cout = shape
    rng = np.random.RandomState(sum(shape))
    x = rng.randn(B, H, W, cin).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = (0.1 * rng.randn(cout)).astype(np.float32)
    ref = np.asarray(_conv_same_int8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     jnp.float32))
    qw = ic.quantize_weight(_t(w.transpose(3, 2, 0, 1)))
    out = ic.conv3x3_int8(_t(x), qw, _t(b), torch.float32)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())


def test_quantize_weight_layout_and_rule():
    """wq is (9, Cout, Cin) int8 with tap = 3*di + dj; dequantized it is the
    weight to within half a step of its channel's scale."""
    w = torch.from_numpy(np.random.RandomState(1).randn(24, 16, 3, 3).astype(np.float32))
    qw = ic.quantize_weight(w)
    assert qw.wq.dtype == torch.int8 and tuple(qw.wq.shape) == (9, 24, 16)
    assert int(qw.wq.abs().max()) == 127
    oihw = qw.wq.reshape(3, 3, 24, 16).permute(2, 3, 0, 1).float()
    err = (oihw * qw.scale[:, None, None, None] - w).abs()
    assert (err <= 0.5 * qw.scale[:, None, None, None] * (1 + 1e-6)).all()


def test_conv_kernel_rejects_unsupported_shapes():
    """The CUDA path validates before it builds or launches, and raises (no
    fall back to the plain version) on what the kernel does not take:
    weights whose Cin is not x's, an x that is not the dtype the kernel
    writes, a dtype it does not write, mismatched bias, slice images of
    another conv, or none (a weight quantized off the card has none). Any
    channel count is taken."""
    qw = ic.quantize_weight(torch.randn(64, 32, 3, 3))
    with pytest.raises(ValueError, match="expected"):
        ic._launch(torch.randn(1, 4, 4, 48), qw, None, torch.float32)
    with pytest.raises(ValueError, match="reads and writes"):
        ic._launch(torch.randn(1, 4, 4, 32), qw, None, torch.bfloat16)
    with pytest.raises(ValueError, match="not supported"):
        ic._launch(torch.randn(1, 4, 4, 32).half(), qw, None, torch.float16)
    with pytest.raises(ValueError, match="bias"):
        ic._launch(torch.randn(1, 4, 4, 32), qw, torch.zeros(63), torch.float32)
    assert qw.images is None
    with pytest.raises(ValueError, match="no slice images"):
        ic._launch(torch.randn(1, 4, 4, 32).bfloat16(), qw, None, torch.bfloat16)
    other = ic.quantize_weight(torch.randn(64, 128, 3, 3))
    bad = qw._replace(images=ic.conv_slice_images(other.wq))
    with pytest.raises(ValueError, match="images have shape"):
        ic._launch(torch.randn(1, 4, 4, 32).bfloat16(), bad, None, torch.bfloat16)


@pytest.mark.parametrize("cin,cout", [(32, 96), (96, 32), (64, 100), (64, 64), (128, 256),
                                      (200, 130)])
def test_conv_slice_images_unpack_to_wq(cin, cout):
    """The bf16 kernel's slice images un-swizzle back to wq exactly, and
    every byte outside wq (channels past Cin or Cout, the tenth tap of a
    64-channel chunk) is zero."""
    qw = ic.quantize_weight(torch.randn(cout, cin, 3, 3))
    images = ic.conv_slice_images(qw.wq)
    mode = ic.conv_mode(cin, cout)
    assert images.shape == (-(-cout // mode.n_t), -(-cin // mode.kc), mode.slices, mode.n_t, 128)
    assert torch.equal(ic.unpack_conv_slice_images(images, cin, cout), qw.wq)
    assert images.abs().sum() == qw.wq.abs().sum()


@pytest.mark.parametrize("cin,cout", [(32, 96), (64, 100), (160, 64)])
def test_slice_images_as_the_kernel_reads_them(cin, cout):
    """The conv computed from the slice images by the bf16 kernel's own
    indexing, in exact integer arithmetic: for chunk c, slice s and k-step
    kk (32 bytes), tap = s (kc = 128) or min(2s + kk // 2, 8) (kc = 64),
    channels c * kc + the k-step's byte offset (32 kk, or 32 (kk % 2));
    B rows un-swizzled from the image. Equals the integer conv of
    int8_matmul_conv."""
    g = torch.Generator().manual_seed(cin + cout)
    qw = ic.quantize_weight(torch.randn(cout, cin, 3, 3, generator=g))
    images = ic.conv_slice_images(qw.wq)
    vq = torch.randint(-127, 128, (1, 5, 6, cin), generator=g).double()
    mode = ic.conv_mode(cin, cout)
    nblk, nch = images.shape[:2]
    xp = torch.nn.functional.pad(vq, (0, nch * mode.kc - cin, 1, 1, 1, 1))  # (1, 7, 8, Cinp)
    img = ic.swizzle_128b(images).double()  # (nblk, nch, slices, n_t, 128)
    acc = torch.zeros(1, 5, 6, nblk * mode.n_t, dtype=torch.float64)
    for c in range(nch):
        for s in range(mode.slices):
            for kk in range(4):
                tap = s if mode.kc == 128 else min(2 * s + kk // 2, 8)
                cb = 32 * kk if mode.kc == 128 else 32 * (kk % 2)
                a = xp[:, tap // 3:tap // 3 + 5, tap % 3:tap % 3 + 6,
                       c * mode.kc + cb:c * mode.kc + cb + 32]
                b = img[:, c, s, :, 32 * kk:32 * kk + 32].reshape(-1, 32)  # (nblk * n_t, 32)
                acc += a @ b.t()
    assert torch.equal(acc[..., :cout].float(), ic.int8_matmul_conv(vq, qw))


@pytest.mark.parametrize("cin", [3, 16, 64, 100])
def test_quantize_pass_plain_is_the_conv_quantization(cin):
    """The bf16 conv's quantize pass (plain version): the levels
    conv3x3_int8_plain quantizes x to, in a copy of quantized_channels(Cin)
    channels whose padding is zero."""
    x = torch.randn(2, 5, 4, cin, generator=torch.Generator().manual_seed(cin)).bfloat16()
    absmax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
    xq = ic.quantize_int8(x, absmax)
    assert xq.dtype == torch.int8 and xq.shape == (2, 5, 4, ic.quantized_channels(cin))
    assert ic.quantized_channels(cin) % 16 == 0 and not xq[..., cin:].any()
    want = torch.clamp(torch.round(x.float() / ic.activation_scale(x)), -127, 127)
    assert torch.equal(xq[..., :cin].float(), want)


@pytest.mark.parametrize("cin,cout", [(32, 96), (96, 32)])
def test_f32_kernel_padding_is_exact(cin, cout):
    """The f32 parity kernel's operands zero-padded to 64-channel multiples
    give exactly the unpadded plain conv in their first Cout channels."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(1, 5, 4, cin, generator=g)
    qw = ic.quantize_weight(torch.randn(cout, cin, 3, 3, generator=g))
    bias = torch.randn(cout, generator=g)
    xp, wq, scale, bp = ic._pad_f32_operands(x, qw, bias)
    assert xp.shape[-1] % 64 == 0 and wq.shape[1] % 64 == 0
    out = ic.conv3x3_int8_plain(xp, ic.QuantizedWeight(wq, scale), bp, torch.float32)
    assert torch.equal(out[..., :cout], ic.conv3x3_int8_plain(x, qw, bias, torch.float32))


# ------------------------------------------------------------ (b) the chain

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 4])
def test_chain_plain_int8_matches_jax(L, dtype):
    """multispade_modulate_plain_int8 against multispade_modulate_reference_int8,
    and the port's wrapper (quantized=True, CPU: the plain version) against
    the JAX package's fused op (quantized=True, CPU: the same reference).
    Within the int8 limits (int8_chain_agrees: elementwise and rms): the
    two sides compute the hidden map by different
    convolutions, so a hidden value next to a .5 quantization boundary may
    round the other way; one such flip moves gamma/beta by at most
    s_l * max|w| around it. (Measured at these inputs: equal.)"""
    case = _make_case(L=L, seed=20 + L)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs, targs = _jax_args(case, jdt), _torch_args(case, dtype)
    pairs = [
        (tfs.multispade_modulate_plain_int8(*targs),
         jfs.multispade_modulate_reference_int8(*jargs)),
        (tfs.fused_multispade_modulate(*targs, quantized=True),
         jfs.fused_multispade_modulate(*jargs, quantized=True)),
    ]
    for out, ref in pairs:
        assert out.dtype == dtype
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(dtype)
        ok, ratio, rms = tfs.int8_chain_agrees(out, ref)
        assert ok, (ratio, rms)


def test_cpu_wrapper_quantized_runs_plain_and_counts_no_launch():
    """On CPU tensors the quantized wrapper computes the plain int8 chain
    (bit-equal), launches nothing, and differs from the fp chain."""
    args = _torch_args(_make_case(B=1, H=9, W=7, C=16, L=2, seed=3), torch.float32)
    counts = [tfs.fused_multispade_modulate.int8_launches,
              tfs.fused_multispade_modulate.absmax_launches]
    out = tfs.fused_multispade_modulate(*args, quantized=True)
    assert counts == [tfs.fused_multispade_modulate.int8_launches,
                      tfs.fused_multispade_modulate.absmax_launches] == [0, 0]
    torch.testing.assert_close(out, tfs.multispade_modulate_plain_int8(*args), rtol=0, atol=0)
    assert (out - tfs.multispade_modulate_plain(*args)).abs().max() > 0


def test_quantized_backward_recomputes_fp():
    """The quantized forward's gradient is the fp plain version's (the JAX
    package's _fused_bwd recomputes through the fp reference)."""
    case = _make_case(B=1, H=8, W=8, C=16, L=2, seed=4)
    grads = []
    for quantized in (True, False):
        x, ab, segs, wshs, bshs, wgbs, bgbs = _torch_args(case, torch.float32)
        x.requires_grad_(True)
        tfs.fused_multispade_modulate(x, ab, segs, wshs, bshs, wgbs, bgbs,
                                      quantized=quantized).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)


def _emulate_int8_kernel(x, ab, segs, packed, fault=None):
    """The quantized kernel's numerics from its packed operands, in torch on
    the CPU, read as the kernel reads them: in bf16 the segmaps padded to
    SEG_CHANNELS (kernel_segmap), the hidden conv over k = tap * 8 + ci to
    HIDDEN_DEPTH, the int8 weights un-swizzled from their slice images; in
    f32 the flat per-label hidden weights and (L, 9, 2C, 128) int8 weights.
    The hidden map by another summation order (unfold + einsum), in bf16
    rounded as the kernel rounds it (the sum, then the sum with the bf16
    bias), one scale a label over the batch, the int8 weights and scales as
    packed, exact integer sums, uncontracted dequantization. A ``fault``
    plants a bug: "per_sample" takes one scale a sample, "no_scale" drops
    s_l from the dequantization. (Weights quantized from their bf16 cast are
    planted by packing such weights.)"""
    bf16 = x.dtype == torch.bfloat16
    rd = (lambda t: t.to(torch.bfloat16).float()) if bf16 else (lambda t: t)
    B, H, W, C = x.shape
    out = x.float()
    seg_all = tfs.kernel_segmap(segs, x.dtype)
    off = 0
    for l, cs in enumerate(packed.cs):
        if bf16:
            c = tfs.SEG_CHANNELS
            cols = _kernel_cols(seg_all[..., c * l:c * (l + 1)], B, H, W)
            cols = torch.cat([cols, cols[:, 8 * c:8 * c + tfs.HIDDEN_DEPTH - 9 * c]], dim=1)
            wsh = packed.wsh[l].float()
            wq = tfs.unpack_slice_images(packed.wgb[l])
        else:
            cols = _kernel_cols(seg_all[..., off:off + cs], B, H, W)
            wsh = packed.wsh[9 * off * tfs.NHID:9 * (off + cs) * tfs.NHID].float()
            wsh = wsh.reshape(9 * cs, tfs.NHID).t()
            wq = packed.wgb[l]
        off += cs
        acc = torch.einsum("nk,bkp->bnp", wsh, cols)
        hid = torch.relu(rd(rd(acc) + rd(packed.bsh[l])[None, :, None]))
        hid = hid.reshape(B, tfs.NHID, H, W).permute(0, 2, 3, 1)
        if fault == "per_sample":
            s = ic.int8_scale(hid.abs().amax(dim=(1, 2, 3)))[:, None, None, None]
        else:
            s = ic.activation_scale(hid)
        q = torch.clamp(torch.round(hid / s), -127, 127)
        qw = ic.QuantizedWeight(wq, packed.sgb[l])
        scale = qw.scale if fault == "no_scale" else s * qw.scale
        gb = ic.int8_matmul_conv(q, qw) * scale + packed.bgb[l]
        a, b = ab[:, l, :C][:, None, None], ab[:, l, C:][:, None, None]
        out = (out * a + b) * (1.0 + gb[..., :C]) + gb[..., C:]
    return out.to(x.dtype)


def _faulty_chain(args, dtype, fault):
    """The emulated kernel with ``fault`` planted; "no_int8" is the
    full-precision chain (a kernel that never quantized)."""
    x, ab, segs, wshs, bshs, wgbs, bgbs = args
    if fault == "no_int8":
        return tfs.multispade_modulate_plain(*args)
    pack_from = [w.to(torch.bfloat16).float() for w in wgbs] if fault == "bf16_weights" else wgbs
    packed = tfs.pack_weights(wshs, bshs, pack_from, bgbs, dtype, quantized=True)
    if dtype == torch.bfloat16:
        assert packed.wgb.dtype == torch.int8 and packed.wsh.dtype == torch.bfloat16
    return _emulate_int8_kernel(x, ab, segs, packed, fault)


FAULTS = [None, "per_sample", "bf16_weights", "no_scale", "no_int8"]


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("fault", FAULTS)
def test_int8_f32_tolerance_separates_flips_from_faults(fault, L):
    """(f32) The int8 limits (int8_chain_agrees: elementwise and rms) accept
    an emulation of the quantized kernel against the plain int8 chain and
    reject each planted fault: one scale a sample instead of one a tensor,
    weights quantized from their bf16 cast, the dequantization without s_l,
    and no int8 at all. (At 2x64x48 pixels the emulation reads rms <= 1.4e-4,
    the faults 0.0046 or more.)"""
    args = _torch_args(_make_case(B=2, H=64, W=48, C=64, L=L, seed=30 + L), torch.float32)
    ref = tfs.multispade_modulate_plain_int8(*args)
    ok, ratio, rms = tfs.int8_chain_agrees(_faulty_chain(args, torch.float32, fault), ref)
    assert ok == (fault is None), (ratio, rms)


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("fault", FAULTS)
def test_int8_bf16_tolerance(fault, L):
    """(bf16, the serving dtype) The same separation: the emulated kernel
    rounds the hidden map as the plain version does, so it agrees to the
    rare quantization flip; each planted fault moves every element and
    fails the rms limit. (At 2x20x13 pixels the emulation reads 0, the
    faults rms 0.0054 or more.)"""
    args = _torch_args(_make_case(B=2, H=20, W=13, C=64, L=L, seed=40 + L), torch.bfloat16)
    ref = tfs.multispade_modulate_plain_int8(*args)
    ok, ratio, rms = tfs.int8_chain_agrees(_faulty_chain(args, torch.bfloat16, fault), ref)
    assert ok == (fault is None), (ratio, rms)


# --------------------------------------------- (c) per-tensor vs the Pallas kernel

def test_per_tensor_scale_within_pallas_int8_envelope():
    """The port quantizes each hidden map with one scale over the batch
    tensor; the Pallas kernel body (interpret mode) takes one a 32-row tile
    and sample. Against the fp reference the port stays within 3e-2 of
    max|ref| and within 2.5x of the Pallas kernel's own error (the envelope
    of tests/test_fused_spade.py::test_kernel_interpret_quantized_close_to_fp)."""
    case = _make_case(B=2, H=32, W=24, C=64, L=2, seed=50)
    x, ab, segs, wshs, bshs, wgbs, bgbs = _jax_args(case, jnp.float32)
    segc, wsh, bsh, _, bgb = jfs._pack_inputs(segs, wshs, bshs, wgbs, bgbs, jnp.float32)
    wgb_q, sgb = jfs._quantize_gb_weights(wgbs)
    pallas = jfs._fused_forward(x, ab, segc, wsh, bsh, wgb_q, bgb, "relu", interpret=True,
                                sgb=sgb)
    ref_fp = jfs.multispade_modulate_reference(x, ab, segs, wshs, bshs, wgbs, bgbs)
    port = tfs.multispade_modulate_plain_int8(*_torch_args(case, torch.float32)).numpy()
    err_port, err_pallas = _rel(port, ref_fp), _rel(pallas, ref_fp)
    assert 0 < err_port < 3e-2
    assert err_port < 2.5 * max(err_pallas, 1e-4), (err_port, err_pallas)


# ---------------------------------------------- (d) resblock and generator

def test_int8_gate():
    """int8_conv_profitable: 3x3 or larger and both channel counts at the floor."""
    assert int8_conv_profitable(3, 64, 128)
    assert not int8_conv_profitable(1, 128, 128)
    assert not int8_conv_profitable(3, 12, 64)
    assert int8_conv_profitable(3, 12, 8, min_channels=8)


@pytest.mark.parametrize("spade", ["multi", "single"])
def test_int8_resblock_matches_jax(spade, monkeypatch):
    """Spectral resblock with a learned shortcut at eval in int8 serving:
    quantized chains, int8 conv_0/conv_1 (min channels 8), the 1x1 shortcut
    in fp. The port is within 2e-3 of max|ref| of JAX (flips at quantization
    boundaries, as in the chain) and under a quarter of the int8-vs-fp
    distance (taken on the port's fp block, which matches JAX's fp block to
    1e-4: test_torch_networks.py); its state_dict equals the fp module's."""
    x, seg = _spade_inputs(60)
    if spade == "multi":
        jm = JResBlock(fin=32, fout=16, norm_G="spectralspadesyncbatch3x3",
                       spade_ctor=JMultiSpade)
        seg_in = seg
        make = lambda q: lambda c: MultiSpade(c, LABELS, "spadesyncbatch3x3", int8=q)  # noqa: E731
        tseg = {k: _t(v) for k, v in seg.items()}
    else:
        jm = JResBlock(fin=32, fout=16, norm_G="spectralspadesyncbatch3x3", spade_ctor=JSPADE)
        seg_in = seg["agnostic"]
        make = lambda q: lambda c: SPADE(c, 4, "spadesyncbatch3x3", int8=q)  # noqa: E731
        tseg = _t(seg_in)
    variables = _with_random_stats(_np(jm.init(jax.random.PRNGKey(61), x, seg_in, train=True)),
                                   62)
    _int8_env(monkeypatch)
    ref = np.asarray(jm.apply(variables, x, seg_in, train=False))

    mods = {}
    for q in (False, True):
        mods[q] = AnySpadeResBlock(32, 16, "spectralspadesyncbatch3x3", make_spade=make(q),
                                   int8=q, int8_min_channels=8)
        convert.load_flax(mods[q], variables, convert.GENERATOR_RENAMES)
    sd_fp, sd_q = mods[False].state_dict(), mods[True].state_dict()
    assert {k: v.shape for k, v in sd_fp.items()} == {k: v.shape for k, v in sd_q.items()}
    assert mods[True].conv_0.int8 and mods[True].conv_1.int8 and not mods[True].conv_s.int8
    with torch.no_grad():
        out, out_fp = (mods[q](_t(x), tseg, train=False).numpy() for q in (True, False))
    assert _rel(out, ref) <= 2e-3
    assert _rel(out, ref) < 0.25 * _rel(out_fp, ref), (_rel(out, ref), _rel(out_fp, ref))


def test_int8_generator_matches_jax(monkeypatch):
    """SamsGenerator at widths 2^3..2^5, 5-frame clips, in int8 serving with
    min channels 8: encode_conv_in (12 -> 8) takes int8 as in JAX,
    decode_conv_out (8 -> 4) stays fp. Within 2e-3 of max|ref| of JAX and
    under a quarter of the int8-vs-fp distance (on the port's fp
    generator)."""
    rng = np.random.RandomState(63)
    B, H, W = 2, 32, 24
    prev = rng.randn(B, 4, H, W, 3).astype(np.float32)
    maps = rng.randn(B, 4, H, W, 2).astype(np.float32)
    cur = {k: rng.randn(B, H, W, c).astype(np.float32) for k, c in LABELS.items()}
    cfg = dict(ngf_pow_outer=3, ngf_pow_inner=5, num_middle=1, n_frames_total=5,
               flow_warp=True, encoder_input="flow", inputs=tuple(LABELS))
    jm = JSamsGenerator(**cfg)
    variables = _with_random_stats(
        _np(jm.init(jax.random.PRNGKey(64), prev, maps, cur, train=True)), 65)
    _int8_env(monkeypatch)
    ref = np.asarray(jm.apply(variables, prev, maps, cur, train=False))
    outs = {}
    for q in (True, False):
        tm = SamsGenerator(**cfg, int8=q, int8_min_channels=8)
        if q:
            assert tm.encode_conv_in.int8 and not tm.decode_conv_out.int8
        convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
        with torch.no_grad():
            outs[q] = tm(_t(prev), _t(maps), {k: _t(v) for k, v in cur.items()},
                         train=False).numpy()
    assert _rel(outs[True], ref) <= 2e-3
    assert _rel(outs[True], ref) < 0.25 * _rel(outs[False], ref)


def test_int8_convs_keep_state_dict_and_train_in_fp():
    """An int8 conv has the fp conv's parameters; called without quantize
    (training) it is the fp conv exactly, and with it the int8 conv."""
    torch.manual_seed(0)
    for cls, kw in ((Conv2d, {}), (SpectralConv2d, {})):
        fp, q = cls(16, 24, 3, padding=1, **kw), cls(16, 24, 3, padding=1, int8=True, **kw)
        torch.nn.init.normal_(fp.weight, std=0.1)
        if cls is SpectralConv2d:
            torch.nn.init.normal_(fp.u)
        q.load_state_dict(fp.state_dict())
        assert fp.state_dict().keys() == q.state_dict().keys()
        x = torch.randn(2, 6, 5, 16)
        with torch.no_grad():
            torch.testing.assert_close(q(x), fp(x), rtol=0, atol=0)
            assert (q(x, quantize=True) - fp(x)).abs().max() > 0
            assert fp(x, quantize=True).equal(fp(x))
        if cls is SpectralConv2d:  # the int8 conv serves eval only
            with pytest.raises(ValueError, match="update_stats"):
                q(x, update_stats=True, quantize=True)
    with pytest.raises(ValueError):
        Conv2d(16, 24, 1, int8=True)


# ----------------------------------------------------------- (e) the clip

def test_int8_serving_clip_matches_jax(monkeypatch):
    """The tiny serving clip with int8_spade=True against the JAX clip of
    bench.py under SHINEON_FUSED_SPADE=1 and SHINEON_INT8_SPADE=1, the same
    weights and warm-up (train mode, fp on both sides): every SPADE chain
    quantized and, with the conv gate's floor at 32 channels on both sides,
    the middle block's two 3x3 convs in int8. max |diff| <= 2e-2 * max|ref|,
    and under a quarter of the JAX clip's own int8-vs-fp distance, so the
    limit tells the same int8 numerics from no int8 at all.

    The floor is 32, not 8: with every conv of this tiny random-weight
    generator in int8, quantization flips cascade through the per-tensor
    scales, and a 1e-6 relative change of one weight tensor moves the JAX
    and the port int8 clips alike by about their int8-vs-fp distance, so no
    limit could separate the two there. test_int8_generator_matches_jax
    holds the all-int8 (floor 8) generator on one frame."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    monkeypatch.setenv("SHINEON_INT8_SPADE", "1")
    monkeypatch.setenv("SHINEON_INT8_MIN_CH", "32")
    jopt = _sams_opt(is_train=False, **TINY)
    jsams = JSamsModel(jopt)
    jwarp = JWarpModel(_sams_opt(is_train=False, model="warp", flow_warp=False, grid_size=5,
                                 person_inputs=["agnostic", "densepose"], **TINY))
    g = jsams.init_state(jax.random.PRNGKey(420), 1).nets["generator"]
    w = jwarp.init_state(jax.random.PRNGKey(7), 1).nets["gmm"]
    warp_vars = {"params": w.params, **w.stats}

    sams = SamsModel(sams_options(int8_spade=True, int8_min_channels=32, **TINY), device="cpu")
    warp = WarpModel(warp_options(**TINY), device="cpu")
    convert.load_flax(sams.generator, _np({"params": g.params, **g.stats}),
                      convert.GENERATOR_RENAMES)
    convert.load_flax(warp.gmm, _np(warp_vars), convert.GMM_RENAMES)
    int8_convs = [n for n, m in sams.generator.named_modules() if getattr(m, "int8", False)
                  and not isinstance(m, (SPADE, MultiSpade))]
    assert int8_convs == ["middle_0.conv_0", "middle_0.conv_1"]

    raw = _raw_batch(_sams_opt(**TINY), batch=2)
    jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in raw.items()}
    feats = jax.jit(jsams.features)(jbatch)
    stats = jax.jit(
        lambda p, s, f: jsams.generate_n_frames(p, s, f, train=True)[3]
    )(g.params, g.stats, feats)
    warm_up(sams, tbatch, rollouts=1)

    ref = np.asarray(_jax_clip(jsams, jwarp)(warp_vars, g.params, stats, jbatch))
    monkeypatch.delenv("SHINEON_INT8_SPADE")
    ref_fp = np.asarray(_jax_clip(jsams, jwarp)(warp_vars, g.params, stats, jbatch))
    out = make_one_clip(warp, sams)(tbatch)
    assert out.shape == (2, 3, 128, 96, 3) and torch.isfinite(out).all()
    err, jax_gap = _rel(out.numpy(), ref), _rel(ref, ref_fp)
    assert err <= 2e-2
    assert err < 0.25 * jax_gap, (err, jax_gap)
