"""Card-only tests of the port's serving path, bf16 and int8, with and
without attention. They import neither JAX nor the JAX package, so they also
run where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m gpu -q

Without a CUDA device they skip."""

import pytest
import torch

# 128x96, 3-frame clips, widths 2^6..2^7: one encoder block (3 SPADE
# sites), one middle block (2) and one decoder block (3), 8 sites a frame
SMALL = dict(fine_height=128, fine_width=96, n_frames_total=3, n_frames_now=3,
             ngf_pow_outer=6, ngf_pow_inner=7, num_middle=1, ngf=8, precision=16)
SITES_PER_FRAME = 8


@pytest.mark.gpu
def test_build_inference_cuda_launches_kernel_per_spade_site():
    """On the card a small bf16 clip launches the chain kernel once per
    SPADE site and gives finite frames of the clip's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate
    from shineon_tpu_torch.serving import build_inference

    one_clip, warp, sams, raw, n_frames = build_inference(2, **SMALL)
    before = fused_multispade_modulate.launches
    frames = one_clip(raw)
    torch.cuda.synchronize()
    assert frames.shape == (2, n_frames, 128, 96, 3)
    assert torch.isfinite(frames.float()).all()
    assert fused_multispade_modulate.launches - before == n_frames * SITES_PER_FRAME


# the same clip in int8 serving: every SPADE site runs the quantized chain
# and its pre-pass; the 3x3 resblock convs run the int8 conv (64->64,
# 64->128 in the encoder block, 128->128 x2 in the middle block, 128->64,
# 64->64 in the decoder block: 6 a frame)
INT8_CONVS_PER_FRAME = 6


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
def test_build_inference_cuda_int8_launches_every_kernel():
    """On the card a small int8 clip launches the quantized chain and its
    pre-pass once per SPADE site, the int8 conv once per gated 3x3 conv, and
    the full-precision chain never."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate as fmm
    from shineon_tpu_torch.ops.int8_conv import conv3x3_int8
    from shineon_tpu_torch.serving import build_inference

    one_clip, warp, sams, raw, n_frames = build_inference(2, int8_spade=True, **SMALL)
    counts = lambda: (fmm.launches, fmm.int8_launches, fmm.absmax_launches,  # noqa: E731
                      conv3x3_int8.launches)
    before = counts()
    frames = one_clip(raw)
    torch.cuda.synchronize()
    assert frames.shape == (2, n_frames, 128, 96, 3)
    assert torch.isfinite(frames.float()).all()
    launched = [a - b for a, b in zip(counts(), before)]
    assert launched == [0, n_frames * SITES_PER_FRAME, n_frames * SITES_PER_FRAME,
                        n_frames * INT8_CONVS_PER_FRAME]


# (H, W, C, segmap channels) of a 4-label decoder site (the current frame's
# labels) and a 1-label encoder site of the serving clip
PLANNED_SITES = {"decoder_4_labels": (64, 48, 256, (4, 3, 3, 2)),
                 "encoder_1_label": (128, 96, 128, (8,))}


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("site", sorted(PLANNED_SITES))
def test_cuda_planned_chain_equals_uncached_launch(site, int8):
    """At a 4-label decoder site and a 1-label encoder site, bf16 and int8:
    fused_chain through its kept plan and shared segmap operand returns the
    same tensor, bit for bit, as fused_multispade_modulate's uncached
    launch on the same operands, with the same launches; its second call
    makes no plan and no segmap operand."""
    _cuda_or_skip()
    from shineon_tpu_torch.networks.sams import spade as tspade
    from shineon_tpu_torch.ops import fused_spade as fs

    H, W, C, cs_list = PLANNED_SITES[site]
    g = torch.Generator().manual_seed(11)
    spades = [tspade.SPADE(C, c, "spadesyncbatch3x3", dtype=torch.bfloat16, int8=int8)
              for c in cs_list]
    with torch.no_grad():
        for s in spades:
            for t in (*s.parameters(), *s.buffers()):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.5)
            s.cuda()
    x = torch.randn(2, H, W, C, generator=g).to(torch.bfloat16).cuda()
    maps = [torch.randn(2, 256, 192, c, generator=g).cuda() for c in cs_list]
    fc, fmm = tspade.fused_chain, fs.fused_multispade_modulate
    counts = lambda: (fc.plan_builds, fc.plan_hits, fc.segmap_builds, fc.segmap_hits,  # noqa: E731
                      fmm.launches, fmm.int8_launches, fmm.absmax_launches)
    with torch.no_grad():
        c0 = counts()
        first = tspade.fused_chain(spades, x, maps)
        c1 = counts()
        second = tspade.fused_chain(spades, x, maps)
        c2 = counts()
        ab, segs, wshs, bshs, wgbs, bgbs = zip(*(s.fused_args(x, m) for s, m in zip(spades, maps)))
        ref = fmm(x, torch.stack(ab, dim=1), segs, wshs, bshs, wgbs, bgbs, quantized=int8)
        c3 = counts()
    torch.cuda.synchronize()
    assert torch.equal(first, ref) and torch.equal(second, ref)
    launched = (0, 1, 1) if int8 else (1, 0, 0)
    assert [b - a for a, b in zip(c0, c1)] == [1, 0, 1, 0, *launched]
    assert [b - a for a, b in zip(c1, c2)] == [0, 1, 0, 1, *launched]
    assert [b - a for a, b in zip(c2, c3)] == [0, 0, 0, 0, *launched]


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_cuda_second_hand_in_makes_no_plan(int8):
    """A small clip's second hand-in launches every SPADE site from its kept
    plan: no plan made, one plan hit a site, and a segmap operand made
    once a frame for each labelmap and resolution (3 a frame here: the
    encoder block's labelmap at 128x96, the current frame's at 64x48 in
    the middle block and at 128x96 in the decoder block)."""
    _cuda_or_skip()
    from shineon_tpu_torch.networks.sams import spade as tspade
    from shineon_tpu_torch.serving import build_inference

    one_clip, warp, sams, raw, n_frames = build_inference(2, int8_spade=int8, **SMALL)
    fc = tspade.fused_chain
    counts = lambda: (fc.plan_builds, fc.plan_hits, fc.segmap_builds, fc.segmap_hits)  # noqa: E731
    c0 = counts()
    one_clip(raw)
    c1 = counts()
    frames = one_clip(raw)
    c2 = counts()
    torch.cuda.synchronize()
    assert torch.isfinite(frames.float()).all()
    sites = n_frames * SITES_PER_FRAME
    assert c1[0] - c0[0] == SITES_PER_FRAME and c1[0] - c0[0] + c1[1] - c0[1] == sites
    assert [b - a for a, b in zip(c1, c2)] == [0, sites, 3 * n_frames, sites - 3 * n_frames]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quantized_chain_matches_plain(dtype):
    """The quantized chain kernel (pre-pass + chain) against its plain
    version at a ragged L=4 site, element by element and in rms within the
    int8 limits (fused_spade.int8_chain_agrees)."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import fused_spade as fs

    g = torch.Generator().manual_seed(5)
    rn = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).cuda()  # noqa: E731
    B, H, W, C, cs_list = 2, 20, 13, 64, (4, 3, 3, 2)
    x = rn(B, H, W, C, scale=0.5).to(dtype)
    ab = torch.cat([1.0 + rn(B, 4, C, scale=0.1), rn(B, 4, C, scale=0.1)], -1)
    segs = [rn(B, H, W, c).to(dtype) for c in cs_list]
    wshs = [rn(128, c, 3, 3, scale=(9 * c) ** -0.5) for c in cs_list]
    bshs = [rn(128, scale=0.1) for _ in cs_list]
    wgbs = [rn(2 * C, 128, 3, 3, scale=(9 * 128) ** -0.5) for _ in cs_list]
    bgbs = [rn(2 * C, scale=0.05) for _ in cs_list]
    args = (x, ab, segs, wshs, bshs, wgbs, bgbs)
    before = (fs.fused_multispade_modulate.int8_launches,
              fs.fused_multispade_modulate.absmax_launches)
    out = fs.fused_multispade_modulate(*args, quantized=True)
    ref = fs.multispade_modulate_plain_int8(*args)
    torch.cuda.synchronize()
    assert (fs.fused_multispade_modulate.int8_launches,
            fs.fused_multispade_modulate.absmax_launches) == (before[0] + 1, before[1] + 1)
    ok, ratio, rms = fs.int8_chain_agrees(out, ref)
    assert ok, (ratio, rms)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["gelu", "swish", "sine"])
def test_cuda_chain_activations_match_plain(act, dtype):
    """Kernels 1 and 2 with a hidden activation other than relu against
    their plain versions at a ragged L=4 site: the full-precision chain
    element by element (fused_spade.KERNEL_TOLERANCE), the quantized one
    within the activation's int8 limits."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import fused_spade as fs

    g = torch.Generator().manual_seed(6)
    rn = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).cuda()  # noqa: E731
    B, H, W, C, cs_list = 2, 20, 13, 64, (4, 3, 3, 2)
    x = rn(B, H, W, C, scale=0.5).to(dtype)
    ab = torch.cat([1.0 + rn(B, 4, C, scale=0.1), rn(B, 4, C, scale=0.1)], -1)
    segs = [rn(B, H, W, c).to(dtype) for c in cs_list]
    wshs = [rn(128, c, 3, 3, scale=(9 * c) ** -0.5) for c in cs_list]
    bshs = [rn(128, scale=0.1) for _ in cs_list]
    wgbs = [rn(2 * C, 128, 3, 3, scale=(9 * 128) ** -0.5) for _ in cs_list]
    bgbs = [rn(2 * C, scale=0.05) for _ in cs_list]
    args = (x, ab, segs, wshs, bshs, wgbs, bgbs)
    out = fs.fused_multispade_modulate(*args, act_name=act)
    ref = fs.multispade_modulate_plain(*args, act_name=act)
    q_out = fs.fused_multispade_modulate(*args, act_name=act, quantized=True)
    q_ref = fs.multispade_modulate_plain_int8(*args, act_name=act)
    torch.cuda.synchronize()
    assert fs.error_ratio(out, ref) <= fs.KERNEL_TOLERANCE[dtype]
    ok, ratio, rms = fs.int8_chain_agrees(q_out, q_ref, act)
    assert ok, (ratio, rms)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_conv_matches_plain(dtype):
    """The int8 3x3 conv kernel against its plain version at a ragged
    64 -> 128 shape, element by element within INT8_CONV_TOLERANCE."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import fused_spade as fs
    from shineon_tpu_torch.ops import int8_conv as ic

    g = torch.Generator().manual_seed(6)
    # leaky_relu(0.2) output, as the clip feeds the conv: both signs
    x = torch.nn.functional.leaky_relu(torch.randn(4, 20, 13, 64, generator=g), 0.2)
    x = x.cuda().to(dtype)
    qw = ic.quantize_weight((torch.randn(128, 64, 3, 3, generator=g) / 24).cuda())
    b = (0.1 * torch.randn(128, generator=g)).cuda()
    before = ic.conv3x3_int8.launches
    out = ic.conv3x3_int8(x, qw, b, dtype)
    ref = ic.conv3x3_int8_plain(x, qw, b, dtype)
    torch.cuda.synchronize()
    assert ic.conv3x3_int8.launches == before + 1
    assert out.dtype == dtype
    assert fs.error_ratio(out, ref) <= ic.INT8_CONV_TOLERANCE[dtype]


# the same small clip with attention in its middle block (64x48 tokens, 4 x
# 128 channels) and decoder block 0 (128x96 tokens; 4 x 128 and 4 x 64):
# 5 attention launches a frame, and one one-label chain a label at each
# attentive site (3 encoder sites + 4 x (2 + 3) = 23 a frame)
ATTENTION = dict(attention_middle_indices=("-1",), attention_decoder_indices=("0",))
ATTENTION_PER_FRAME, ATTENTION_CHAINS_PER_FRAME = 5, 23


@pytest.mark.gpu
def test_build_inference_cuda_attention_launches_every_kernel():
    """On the card a small bf16 attention clip launches the attention kernel
    at every attention block and the chain kernel at every SPADE site."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops.fused_attention import sagan_attention
    from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate as fmm
    from shineon_tpu_torch.serving import build_inference

    one_clip, warp, sams, raw, n_frames = build_inference(2, **SMALL, **ATTENTION)
    before = (fmm.launches, sagan_attention.launches)
    frames = one_clip(raw)
    torch.cuda.synchronize()
    assert frames.shape == (2, n_frames, 128, 96, 3)
    assert torch.isfinite(frames.float()).all()
    assert (fmm.launches - before[0], sagan_attention.launches - before[1]) == (
        n_frames * ATTENTION_CHAINS_PER_FRAME, n_frames * ATTENTION_PER_FRAME)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_matches_plain(dtype):
    """The attention kernel against its plain version at a ragged shape
    (N = 260, d = 64, dv = 512) with peaked score rows, element by element
    within ATTENTION_TOLERANCE; the kernel on 1/sqrt(d)-scaled scores fails
    that limit."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import fused_attention as fa
    from shineon_tpu_torch.ops import fused_spade as fs

    g = torch.Generator().manual_seed(7)
    sigma = (8.0 / 64 ** 0.5) ** 0.5  # raw scores of std about 8
    q, k = ((sigma * torch.randn(2, 260, 64, generator=g)).cuda().to(dtype) for _ in range(2))
    v = torch.randn(2, 260, 512, generator=g).cuda().to(dtype)
    before = fa.sagan_attention.launches
    out = fa.sagan_attention(q, k, v)
    ref = fa.attention_plain(q, k, v)
    scaled = fa.sagan_attention((q.float() / 8.0).to(dtype), k, v)
    torch.cuda.synchronize()
    assert fa.sagan_attention.launches == before + 2
    assert out.dtype == dtype
    tol = fa.ATTENTION_TOLERANCE[dtype]
    assert fs.error_ratio(out, ref) <= tol
    assert fs.error_ratio(scaled, ref) > tol


@pytest.mark.gpu
def test_cuda_attention_value_chunk():
    """The value columns a block of the attention kernel owns (each block
    computes its queries' scores once), as the built kernel reports them:
    the wrapper's BLOCK_COLS, 512, so the QK^T work is ceil(dv / 512) times
    the minimum (1.33x at d = 256, dv = 2048)."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import fused_attention as fa

    assert fa._library().sagan_attention_block_cols() == fa.BLOCK_COLS == 512


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,d,dv", [(192, 8, 64), (100, 108, 864), (192, 640, 5120),
                                    (150, 64, 320), (130, 64, 512)])
def test_cuda_attention_repaired_widths(N, d, dv, dtype):
    """The attention kernel at widths the first kernel refused (d = 8, 108
    and 640; dv = 864) and at its block edges (dv = 320 fills part of one
    512-column block, 512 exactly one, 864 one and most of another; N = 150
    and 130 leave a ragged query and key tile),
    peaked score rows, within ATTENTION_TOLERANCE of its plain version."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import fused_attention as fa
    from shineon_tpu_torch.ops import fused_spade as fs

    g = torch.Generator().manual_seed(N + d + dv)
    sigma = (8.0 / d ** 0.5) ** 0.5  # raw scores of std about 8
    q, k = ((sigma * torch.randn(2, N, d, generator=g)).cuda().to(dtype) for _ in range(2))
    v = torch.randn(2, N, dv, generator=g).cuda().to(dtype)
    out = fa.sagan_attention(q, k, v)
    ref = fa.attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == (2, N, dv) and out.dtype == dtype
    assert fs.error_ratio(out, ref) <= fa.ATTENTION_TOLERANCE[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 13, 32, 96), (20, 13, 96, 32), (20, 13, 64, 100),
                                   (16, 12, 1024, 1024), (9, 7, 3, 5)])
def test_cuda_int8_conv_repaired_shapes(shape, dtype):
    """The int8 conv kernel at channel counts off the first kernel's
    64-channel tiles, at 16x12, 1024 -> 1024 (its K split across blocks at
    the clip's batch) and at 3 channels (no tensor-map copy: a row of 6
    bytes), within INT8_CONV_TOLERANCE of its plain version."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import fused_spade as fs
    from shineon_tpu_torch.ops import int8_conv as ic

    H, W, cin, cout = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.nn.functional.leaky_relu(torch.randn(4, H, W, cin, generator=g), 0.2)
    x = x.cuda().to(dtype)
    qw = ic.quantize_weight((torch.randn(cout, cin, 3, 3, generator=g) / (9 * cin) ** 0.5).cuda())
    assert qw.images is not None
    b = (0.1 * torch.randn(cout, generator=g)).cuda()
    if shape == (16, 12, 1024, 1024) and dtype == torch.bfloat16:
        assert ic.plan(4, H, W, cin, cout)[1] > 1
    out = ic.conv3x3_int8(x, qw, b, dtype)
    ref = ic.conv3x3_int8_plain(x, qw, b, dtype)
    torch.cuda.synchronize()
    assert out.shape == (4, H, W, cout) and out.dtype == dtype
    assert fs.error_ratio(out, ref) <= ic.INT8_CONV_TOLERANCE[dtype]


# every layout probe of csrc/probes.cu: the 10 movement probes (the
# gather kernel's 16-byte units, aligned (B, B2, E, F, G, H, L) and
# funnel-shifted (K), and the transposes C, C2), the 4 contractions (A
# and A2 by TMA, A2 through the transpose bit; D and I by the flat slab),
# the mini chain (M); and the tap products (mmonly)
PROBE_FAMILIES = ("probe_a", "probe_a2", "probe_b", "probe_b2", "probe_c", "probe_c2", "probe_d",
                  "probe_e", "probe_f", "probe_g", "probe_h", "probe_i", "probe_k", "probe_l",
                  "probe_m", "conv_mmonly")


@pytest.mark.gpu
@pytest.mark.parametrize("name", PROBE_FAMILIES)
def test_cuda_probe_kernel_matches_plain(name):
    """A probe kernel against its plain version on seeded inputs within
    probes.TOLERANCE (exact for movement); the same inputs on the CPU take
    the plain version and launch nothing, on the card the kernel once."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import int8_conv as ic
    from shineon_tpu_torch.ops import probes as pr

    if name in pr.SPECS:
        args = pr.random_inputs(name, seed=9)
    else:
        g = torch.Generator().manual_seed(9)
        qw = ic.quantize_weight(0.05 * torch.randn(128, 64, 3, 3, generator=g))
        xp, s = pr.quantize_padded(torch.randn(2, 20, 13, 64, generator=g))
        args = (xp, qw, (s * qw.scale).contiguous(), 0.1 * torch.randn(128, generator=g))
    wrapper = pr.WRAPPERS[name]
    before = wrapper.launches
    ref = wrapper(*args)
    assert wrapper.launches == before
    cuda_args = tuple(pr.with_tap_images(ic.QuantizedWeight(a.wq.cuda(), a.scale.cuda()))
                      if isinstance(a, tuple) else a.cuda() for a in args)
    out = wrapper(*cuda_args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ok, err, ratio = pr.agrees(name, out.cpu(), ref)
    assert ok, (err, ratio)


# edge cases of the bf16 chain kernels' tiling, labels and segmap channels:
# (H, W, C, segmap channels of the labels)
CHAIN_EDGES = (
    (20, 13, 64, (4, 3, 3, 2)),  # 3 ragged pixel tiles; one channel tile
    (8, 16, 128, (1,)),  # one pixel tile; L = 1, cs = 1
    (16, 12, 64, (8,) * 8),  # W below the tile width; L = 8, cs = 8
    (24, 40, 192, (2, 8, 1)),  # 9 pixel tiles, 3 channel tiles
    (20, 13, 64, (12,)),  # a label of two 8-channel segments
    (20, 13, 64, (18, 3)),  # three segments (cocopose), beside one
    (20, 13, 96, (4, 3)),  # C off the 64-channel tile (zero-padded to 128)
    (16, 12, 64, (40,)),  # five segments: streamed through a buffer of four
)


def _chain_case(H, W, C, cs_list, seed, B=2):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s, scale=1.0: (torch.randn(s, generator=g) * scale).cuda()  # noqa: E731
    L = len(cs_list)
    x = rn(B, H, W, C, scale=0.5).to(torch.bfloat16)
    ab = torch.cat([1.0 + rn(B, L, C, scale=0.1), rn(B, L, C, scale=0.1)], -1)
    segs = [rn(B, H, W, c).to(torch.bfloat16) for c in cs_list]
    wshs = [rn(128, c, 3, 3, scale=(9 * c) ** -0.5) for c in cs_list]
    bshs = [rn(128, scale=0.1) for _ in cs_list]
    wgbs = [rn(2 * C, 128, 3, 3, scale=(9 * 128) ** -0.5) for _ in cs_list]
    bgbs = [rn(2 * C, scale=0.05) for _ in cs_list]
    return x, ab, segs, wshs, bshs, wgbs, bgbs


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("case", CHAIN_EDGES)
def test_cuda_bf16_chain_edges(case, quantized):
    """The bf16 chain kernels (full precision and quantized) against their
    plain versions at the edges of their tiling, labels and segmap
    channels: an odd count of ragged pixel tiles, one tile, one channel
    tile, L = 1 and 8, cs = 1 and 8, W below the tile width, labels of 12,
    18 and 40 channels, C = 96; within KERNEL_TOLERANCE (full precision) or
    the int8 limits (int8_chain_agrees)."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import fused_spade as fs

    args = _chain_case(*case, seed=sum(case[:3]))
    out = fs.fused_multispade_modulate(*args, quantized=quantized)
    plain = fs.multispade_modulate_plain_int8 if quantized else fs.multispade_modulate_plain
    ref = plain(*args)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
    if quantized:
        ok, ratio, rms = fs.int8_chain_agrees(out, ref)
        assert ok, (ratio, rms)
    else:
        assert fs.error_ratio(out, ref) <= fs.KERNEL_TOLERANCE[torch.bfloat16]


# ragged shapes of the tap-product kernels (B, H, W, Cin, Cout): H and W off
# every tile, one pixel, several column bands; every Cin and Cout family
TAP_CASES = ((1, 17, 23, 64, 64), (2, 17, 23, 128, 192), (3, 1, 1, 192, 256),
             (2, 64, 200, 128, 128), (1, 5, 37, 64, 256), (2, 9, 130, 192, 64))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["conv_mmonly", "conv_taps9bf16"])
@pytest.mark.parametrize("shape", TAP_CASES)
def test_cuda_tap_kernels_ragged(name, shape):
    """Each tap-product kernel at ragged shapes against its plain version
    (INT8_CONV_TOLERANCE[bf16]), one launch each; the output sits before a
    NaN tail that must stay NaN."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import int8_conv as ic
    from shineon_tpu_torch.ops import probes as pr

    B, H, W, cin, cout = shape
    g = torch.Generator().manual_seed(sum(shape))
    qw = pr.with_tap_images(ic.quantize_weight(0.05 * torch.randn(cout, cin, 3, 3, generator=g)
                                               .cuda()))
    xp, s = pr.quantize_padded(torch.randn(B, H, W, cin, generator=g).cuda())
    scale, bias = (s * qw.scale).contiguous(), (0.1 * torch.randn(cout, generator=g)).cuda()
    buf = torch.full((B * H * W * cout + 4096,), float("nan"), dtype=torch.bfloat16,
                     device="cuda")
    out = buf[:B * H * W * cout].view(B, H, W, cout)
    pr._taps(name == "conv_taps9bf16", xp, qw, scale, bias, out=out)
    ref = pr.plain_version(name)(xp, qw, scale, bias)
    torch.cuda.synchronize()
    ok, err, ratio = pr.agrees(name, out, ref)
    assert ok, (err, ratio)
    assert torch.isnan(buf[B * H * W * cout:].float()).all()


# ragged transposes (R, C): each route (8 x 8 blocks, 8-column groups of
# 12 rows, slabs) with R and C off their tiles, one element, probe C's and
# C2's shapes
TRANSPOSE_CASES = ((1, 1), (13, 37), (12, 4000), (12, 4001), (14, 72), (128, 4000),
                   (130, 4100), (136, 20), (4001, 7))


@pytest.mark.gpu
@pytest.mark.parametrize("R,C", TRANSPOSE_CASES)
def test_cuda_transpose_ragged(R, C):
    """The transpose kernels at ragged shapes equal x.t() exactly, by the
    route the plan gives; the output sits before a NaN tail that must stay
    NaN."""
    _cuda_or_skip()
    from shineon_tpu_torch.ops import probes as pr

    g = torch.Generator().manual_seed(R * C)
    x = torch.randn(R, C, generator=g).to(torch.bfloat16).cuda()
    buf = torch.full((R * C + 4096,), float("nan"), dtype=torch.bfloat16, device="cuda")
    out = buf[:R * C].view(C, R)
    _, route = pr.transpose_routed(x, out=out)
    torch.cuda.synchronize()
    assert route == pr.transpose_plan(R, C, (x.data_ptr(), out.data_ptr())).route
    assert torch.equal(out, x.t())
    assert torch.isnan(buf[R * C:].float()).all()
