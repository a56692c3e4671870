"""The port's fused MultiSPADE chain (shineon_tpu_torch/ops/fused_spade.py)
against the JAX package: the conv-by-conv reference and the Pallas kernel
in interpret mode, on the CPU. Inputs come from a numpy seed and go to both.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from shineon_tpu.ops import fused_spade as jfs
from shineon_tpu_torch.ops import fused_spade as tfs
from shineon_tpu_torch.ops import int8_conv as ic
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)


def _make_case(B=2, H=20, W=13, C=64, L=4, seed=0, cs_list=None):
    """numpy inputs; weights HWIO as the JAX package takes them."""
    rng = np.random.RandomState(seed)
    if cs_list is None:
        cs_list = [4, 3, 3, 2][:L] if L > 1 else [8]
    L = len(cs_list)
    x = (rng.randn(B, H, W, C) * 0.5).astype(np.float32)
    a = 1.0 + 0.1 * rng.randn(B, L, C)
    b = 0.1 * rng.randn(B, L, C)
    ab = np.concatenate([a, b], -1).astype(np.float32)
    segs, wshs, bshs, wgbs, bgbs = [], [], [], [], []
    for cs in cs_list:
        segs.append(rng.randn(B, H, W, cs).astype(np.float32))
        wshs.append((rng.randn(3, 3, cs, jfs.NHID) / np.sqrt(9 * cs)).astype(np.float32))
        bshs.append((0.1 * rng.randn(jfs.NHID)).astype(np.float32))
        wgbs.append((rng.randn(3, 3, jfs.NHID, 2 * C) / np.sqrt(9 * jfs.NHID)).astype(np.float32))
        bgbs.append((0.05 * rng.randn(2 * C)).astype(np.float32))
    return x, ab, segs, wshs, bshs, wgbs, bgbs


def _jax_args(case, dtype):
    x, ab, segs, wshs, bshs, wgbs, bgbs = case
    j = lambda v: jnp.asarray(v)  # noqa: E731
    return (jnp.asarray(x, dtype), j(ab), [jnp.asarray(s, dtype) for s in segs],
            [j(w) for w in wshs], [j(b) for b in bshs], [j(w) for w in wgbs],
            [j(b) for b in bgbs])


def _torch_args(case, dtype, device="cpu"):
    """HWIO -> OIHW; everything on ``device``."""
    x, ab, segs, wshs, bshs, wgbs, bgbs = case
    t = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)  # noqa: E731
    oihw = lambda w: t(w.transpose(3, 2, 0, 1))  # noqa: E731
    return (t(x).to(dtype), t(ab), [t(s).to(dtype) for s in segs],
            [oihw(w) for w in wshs], [t(b) for b in bshs], [oihw(w) for w in wgbs],
            [t(b) for b in bgbs])


def _max_rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("L", [1, 4])
def test_plain_matches_jax_reference_f32(L):
    """f32, H=20 (not a multiple of the TPU's 32-row tile): atol 2e-4, the
    JAX package's own kernel-vs-reference tolerance."""
    case = _make_case(L=L)
    ref = jfs.multispade_modulate_reference(*_jax_args(case, jnp.float32))
    out = tfs.multispade_modulate_plain(*_torch_args(case, torch.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-4)


@pytest.mark.parametrize("L", [1, 4])
def test_plain_matches_pallas_interpret_f32(L):
    """The Pallas kernel body in interpret mode, f32: atol 2e-4."""
    case = _make_case(L=L, seed=1)
    x, ab, segs, wshs, bshs, wgbs, bgbs = _jax_args(case, jnp.float32)
    packed = jfs._pack_inputs(segs, wshs, bshs, wgbs, bgbs, jnp.float32)
    ref = jfs._fused_forward(x, ab, *packed, "relu", interpret=True)
    out = tfs.multispade_modulate_plain(*_torch_args(case, torch.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-4)


@pytest.mark.parametrize("L", [1, 4])
def test_plain_matches_jax_reference_bf16(L):
    """bf16 end to end: max |diff| <= 3e-2 * max |ref|. Both round the
    hidden map and the conv outputs to bf16, at places that differ between
    XLA's and PyTorch's CPU convolutions."""
    case = _make_case(L=L, seed=2)
    ref = jfs.multispade_modulate_reference(*_jax_args(case, jnp.bfloat16))
    out = tfs.multispade_modulate_plain(*_torch_args(case, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    assert _max_rel(out.float().numpy(), ref.astype(jnp.float32)) <= 3e-2


# the shapes the first kernels refused: labels of more than 8 segmap
# channels (a densepose encoder map at 5 frames, cocopose) and a width that
# is not a multiple of the 64-channel tile
REPAIRED = [((12,), 64), ((18, 3), 64), ((4, 3), 96)]


@pytest.mark.parametrize("cs_list,C", REPAIRED)
def test_plain_matches_jax_at_repaired_shapes(cs_list, C):
    """f32 at the repaired shapes: the plain version against the JAX
    reference and the Pallas kernel in interpret mode, atol 2e-4 as above."""
    case = _make_case(B=1, H=9, W=7, C=C, seed=11, cs_list=cs_list)
    x, ab, segs, wshs, bshs, wgbs, bgbs = jargs = _jax_args(case, jnp.float32)
    out = tfs.multispade_modulate_plain(*_torch_args(case, torch.float32)).numpy()
    ref = jfs.multispade_modulate_reference(*jargs)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=2e-4)
    packed = jfs._pack_inputs(segs, wshs, bshs, wgbs, bgbs, jnp.float32)
    ref = jfs._fused_forward(x, ab, *packed, "relu", interpret=True)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=2e-4)


@pytest.mark.parametrize("cs_list,C", REPAIRED)
def test_channel_padding_is_exact(cs_list, C):
    """x and ab zero-padded to the channel tile (pad_channels), through the
    plain chain with gamma/beta weights padded as pack_weights pads them:
    the first C channels are the unpadded chain's to f32 rounding (more
    output channels may change the order of the convolution's sums), the
    rest zero, in full precision and quantized."""
    x, ab, segs, wshs, bshs, wgbs, bgbs = _torch_args(
        _make_case(B=1, H=9, W=7, C=C, seed=12, cs_list=cs_list), torch.float32)
    Cp = tfs.padded_channels(C)
    xp, abp = tfs.pad_channels(x, ab, Cp)
    wgbp = [tfs._pad_gamma_beta(w, Cp) for w in wgbs]
    bgbp = [tfs._pad_gamma_beta(b, Cp) for b in bgbs]
    for plain in (tfs.multispade_modulate_plain, tfs.multispade_modulate_plain_int8):
        ref = plain(x, ab, segs, wshs, bshs, wgbs, bgbs)
        out = plain(xp, abp, segs, wshs, bshs, wgbp, bgbp)
        assert tuple(out.shape) == (1, 9, 7, Cp)
        assert tfs.error_ratio(out[..., :C], ref) <= 1e-6 and not out[..., C:].any()


def test_cpu_wrapper_runs_plain_and_counts_no_launch():
    """On CPU tensors the wrapper computes the plain version (bit-equal)
    and launches nothing."""
    case = _make_case(B=1, H=9, W=7, C=16, L=2, seed=3)
    args = _torch_args(case, torch.float32)
    before = tfs.fused_multispade_modulate.launches
    out = tfs.fused_multispade_modulate(*args)
    assert tfs.fused_multispade_modulate.launches == before == 0
    torch.testing.assert_close(out, tfs.multispade_modulate_plain(*args), rtol=0, atol=0)


def test_autograd_backward_matches_plain():
    """The autograd Function recomputes through the plain version: its
    gradients equal autograd through the plain version (rtol 1e-5, same
    arithmetic in another graph)."""
    case = _make_case(B=1, H=8, W=8, C=16, L=2, seed=4)
    grads = []
    for fn in (tfs.fused_multispade_modulate, tfs.multispade_modulate_plain):
        x, ab, segs, wshs, bshs, wgbs, bgbs = _torch_args(case, torch.float32)
        for t in (x, ab, wshs[0], wgbs[1]):
            t.requires_grad_(True)
        (fn(x, ab, segs, wshs, bshs, wgbs, bgbs) ** 2).sum().backward()
        grads.append([t.grad for t in (x, ab, wshs[0], wgbs[1])])
    for g_fused, g_plain in zip(*grads):
        torch.testing.assert_close(g_fused, g_plain, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain(dtype):
    """The CUDA kernel against the plain version on the card, a ragged
    tile (H=20, W=13) and L=4, element by element: |diff| <= tol *
    (|ref| + rms(ref)) with tol = KERNEL_TOLERANCE (2e-4 f32, 0.15 bf16;
    accumulation order, in bf16 also where each side rounds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _torch_args(_make_case(L=4, seed=5), dtype, device="cuda")
    before = tfs.fused_multispade_modulate.launches
    out = tfs.fused_multispade_modulate(*args)
    ref = tfs.multispade_modulate_plain(*args)
    torch.cuda.synchronize()
    assert tfs.fused_multispade_modulate.launches == before + 1
    assert tfs.error_ratio(out, ref) <= tfs.KERNEL_TOLERANCE[dtype]


def _emulate_bf16_numerics(x, ab, segs, wshs, bshs, wgbs, bgbs, fault=None):
    """The bf16 kernel's numerics in f32 torch: bf16 operands, f32 sums, the
    hidden map rounded once, gamma/beta kept in f32, y rounded once. A
    ``fault`` plants a bug: "halo" leaves the hidden map unmasked outside the
    image, "bgb" / "bsh" drop the gamma/beta or hidden-conv bias."""
    F = torch.nn.functional
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    C = x.shape[-1]
    out = x.float()
    for l in range(len(segs)):
        seg = segs[l].float().permute(0, 3, 1, 2)
        bsh = bshs[l] * (fault != "bsh")
        if fault == "halo":  # hidden over the image and its 1-pixel ring, unmasked
            hid = bf(F.relu(F.conv2d(F.pad(seg, (2, 2, 2, 2)), bf(wshs[l]), bsh)))
            gb = F.conv2d(hid, bf(wgbs[l]))
        else:
            hid = bf(F.relu(F.conv2d(seg, bf(wshs[l]), bsh, padding=1)))
            gb = F.conv2d(hid, bf(wgbs[l]), padding=1)
        gb = gb.permute(0, 2, 3, 1) + bgbs[l] * (fault != "bgb")
        a, b = ab[:, l, :C][:, None, None], ab[:, l, C:][:, None, None]
        out = (out * a + b) * (1.0 + gb[..., :C]) + gb[..., C:]
    return out.to(x.dtype)


@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("fault", [None, "halo", "bgb", "bsh"])
def test_bf16_tolerance_separates_rounding_from_faults(fault, L):
    """KERNEL_TOLERANCE in bf16 accepts the kernel's own rounding against
    the plain version and rejects each planted fault."""
    args = _torch_args(_make_case(H=20, W=13, L=L, seed=7), torch.bfloat16)
    ratio = tfs.error_ratio(_emulate_bf16_numerics(*args, fault=fault),
                            tfs.multispade_modulate_plain(*args))
    tol = tfs.KERNEL_TOLERANCE[torch.bfloat16]
    assert ratio <= tol if fault is None else ratio > tol


def _kernel_cols(seg, B, H, W):
    """3x3 patches of a (B, H, W, c) segmap as the kernels read them, (B,
    9 * c, H * W) with k = tap * c + ci, zero outside the image."""
    c = seg.shape[-1]
    cols = torch.nn.functional.unfold(seg.float().permute(0, 3, 1, 2), 3, padding=1)
    return cols.reshape(B, c, 9, H * W).transpose(1, 2).reshape(B, 9 * c, H * W)


def _emulate_kernel(x, ab, segs, packed, bf16_layout):
    """The chain computed from the kernel's packed operands, in f32 torch:
    what the CUDA kernel indexes, so a wrong layout shows on the CPU. bf16:
    each label's segmap padded to whole segments of SEG_CHANNELS in the one
    segmap operand (kernel_segmap), the hidden conv summed over the label's
    segments, each over k = tap * 8 + ci to HIDDEN_DEPTH (past tap 8 the
    kernel reads tap 8's position against zero weights), the [gamma | beta]
    weights un-swizzled from their slice images. Both: gamma and beta at
    padded_channels(C), of which the first C are kept."""
    B, H, W, C = x.shape
    Cp = tfs.padded_channels(C)
    out = x.float()
    seg_all = tfs.kernel_segmap(segs, torch.bfloat16 if bf16_layout else torch.float32)
    c = tfs.SEG_CHANNELS
    off = soff = 0
    for l, cs in enumerate(packed.cs):
        if bf16_layout:
            hid = 0
            for s in range(soff, soff + tfs.segments(cs)):
                cols = _kernel_cols(seg_all[..., c * s:c * (s + 1)], B, H, W)
                pad = tfs.HIDDEN_DEPTH - 9 * c
                cols = torch.cat([cols, cols[:, 8 * c:8 * c + pad]], dim=1)
                hid = hid + torch.einsum("nk,bkp->bnp", packed.wsh[s].float(), cols)
            soff += tfs.segments(cs)
            wgb = tfs.unpack_slice_images(packed.wgb[l]).float()  # (9, 2Cp, 128)
        else:
            cols = _kernel_cols(seg_all[..., off:off + cs], B, H, W)
            wsh = packed.wsh[9 * off * tfs.NHID:9 * (off + cs) * tfs.NHID].float()
            hid = torch.einsum("nk,bkp->bnp", wsh.reshape(9 * cs, tfs.NHID).t(), cols)
            wgb = packed.wgb[l].float().transpose(1, 2)  # (9, 2Cp, 128)
        off += cs
        hid = torch.relu(hid + packed.bsh[l][None, :, None]).reshape(B, tfs.NHID, H, W)
        hcols = torch.nn.functional.unfold(hid, 3, padding=1).reshape(B, tfs.NHID, 9, H * W)
        gb = torch.einsum("tmk,bktp->bpm", wgb, hcols) + packed.bgb[l]
        gb = gb.reshape(B, H, W, 2 * Cp)
        a, b = ab[:, l, :C][:, None, None], ab[:, l, C:][:, None, None]
        out = (out * a + b) * (1.0 + gb[..., :C]) + gb[..., Cp:Cp + C]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_layouts_match_plain(dtype):
    """pack_weights lays the weights out as the kernel reads them (bf16:
    swizzled K-major slice images for wgmma, the hidden depth over 8-channel
    padded segmaps; f32: output channel contiguous). Emulating the kernel's
    indexing in f32 on the packed operands reproduces the plain version
    within 1e-4 of its scale (weights and segmaps rounded to the packed
    dtype once)."""
    x, ab, segs, wshs, bshs, wgbs, bgbs = _torch_args(_make_case(B=1, H=9, W=7, C=64, L=4, seed=6),
                                                      torch.float32)
    wshs = [w.to(dtype).float() for w in wshs]
    wgbs = [w.to(dtype).float() for w in wgbs]
    segs = [s.to(dtype).float() for s in segs]
    packed = tfs.pack_weights(wshs, bshs, wgbs, bgbs, dtype)
    assert packed.wgb.dtype == packed.wsh.dtype == dtype
    out = _emulate_kernel(x, ab, segs, packed, dtype == torch.bfloat16)
    ref = tfs.multispade_modulate_plain(x, ab, segs, wshs, bshs, wgbs, bgbs)
    assert _max_rel(out.numpy(), ref.numpy()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cs_list,C", REPAIRED)
def test_packed_layouts_match_plain_at_repaired_shapes(cs_list, C, dtype):
    """As test_packed_layouts_match_plain, at labels of two and three
    8-channel segments and at C = 96 (packed at 128 channels)."""
    x, ab, segs, wshs, bshs, wgbs, bgbs = _torch_args(
        _make_case(B=1, H=9, W=7, C=C, seed=13, cs_list=cs_list), torch.float32)
    wshs = [w.to(dtype).float() for w in wshs]
    wgbs = [w.to(dtype).float() for w in wgbs]
    segs = [s.to(dtype).float() for s in segs]
    packed = tfs.pack_weights(wshs, bshs, wgbs, bgbs, dtype)
    if dtype == torch.bfloat16:
        assert packed.wsh.shape[0] == sum(tfs.segments(c) for c in cs_list)
    out = _emulate_kernel(x, ab, segs, packed, dtype == torch.bfloat16)
    ref = tfs.multispade_modulate_plain(x, ab, segs, wshs, bshs, wgbs, bgbs)
    assert _max_rel(out.numpy(), ref.numpy()) <= 1e-4


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C", [64, 128, 192])
def test_slice_index_is_a_permutation(C, int8):
    """Every element of a tap's (2C, 128) weights lands in exactly one place
    of its slice images, and row n, element k of image j sits where the
    128-byte swizzle puts it."""
    idx = tfs.slice_index(C, int8)
    assert torch.equal(idx.sort().values, torch.arange(2 * C * tfs.NHID))
    img = idx.reshape(C // 64, -1)
    for j, n, k in ((0, 0, 0), (C // 64 - 1, 70, 100), (0, 127, 127), (C // 64 - 1, 9, 33)):
        row = (n if n < 64 else C + n - 64) + 64 * j
        if int8:
            at = n * 128 + ((k // 16) ^ (n % 8)) * 16 + k % 16
        else:
            at = (k // 64) * 8192 + n * 64 + (((k % 64) // 8) ^ (n % 8)) * 8 + k % 8
        assert img[j, at] == row * tfs.NHID + k


@pytest.mark.parametrize("C", [64, 128])
@pytest.mark.parametrize("cs", [1, 2, 8])
@pytest.mark.parametrize("L", [1, 4, 8])
def test_unpacking_returns_each_weight(L, cs, C):
    """Un-packing the bf16 and the quantized bf16 operands returns each
    OIHW weight exactly once at its (n, k): the slice images give back the
    (tap, output channel, hidden channel) weights (bf16, or int8 as
    quantize_weight makes them) and the hidden weights (128, 80) hold
    w[n, ci, di, dj] at k = (3 di + dj) * 8 + ci and zeros elsewhere."""
    g = torch.Generator().manual_seed(L * 100 + cs * 10 + C)
    wshs = [torch.randn(128, cs, 3, 3, generator=g) for _ in range(L)]
    bshs = [torch.randn(128, generator=g) for _ in range(L)]
    wgbs = [torch.randn(2 * C, 128, 3, 3, generator=g) for _ in range(L)]
    bgbs = [torch.randn(2 * C, generator=g) for _ in range(L)]
    for quantized in (False, True):
        packed = tfs.pack_weights(wshs, bshs, wgbs, bgbs, torch.bfloat16, quantized)
        assert tuple(packed.wgb.shape) == (L, 9, C // 64, tfs.SLICE_ELEMS)
        assert tuple(packed.wsh.shape) == (L, 128, tfs.HIDDEN_DEPTH)
        for l in range(L):
            want = (ic.quantize_weight(wgbs[l]).wq if quantized
                    else wgbs[l].to(torch.bfloat16).permute(2, 3, 0, 1).reshape(9, 2 * C, 128))
            assert torch.equal(tfs.unpack_slice_images(packed.wgb[l]), want)
            wsh = packed.wsh[l, :, :9 * tfs.SEG_CHANNELS].reshape(128, 3, 3, tfs.SEG_CHANNELS)
            assert torch.equal(wsh[..., :cs].permute(0, 3, 1, 2), wshs[l].to(torch.bfloat16))
            assert not wsh[..., cs:].any() and not packed.wsh[l, :, 9 * tfs.SEG_CHANNELS:].any()
