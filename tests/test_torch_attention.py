"""The port's SAGAN attention against the JAX package on the CPU: the op
(ops/fused_attention.py vs shineon_tpu/ops/fused_attention.py, its einsum
reference, its Pallas kernel body in interpret mode and its custom VJP),
SelfAttention, AttentiveMultiSpade and the SAMS generator with attention
blocks, in f32 and under int8 serving. Inputs come from a numpy seed and go
to both; weights are made in JAX and carried across with
shineon_tpu_torch.convert.

gamma starts at 0, which makes an attention block the identity whatever the
attention computes, so every comparison here first sets each gamma
nonzero; test_gamma_zero_blinds_the_block_to_attention shows that without
it the block would not see the attention at all."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shineon_tpu.networks.attention import SelfAttention as JSelfAttention
from shineon_tpu.networks.sams import SamsGenerator as JSamsGenerator
from shineon_tpu.networks.sams.attentive_multispade import (
    AttentiveMultiSpade as JAttentiveMultiSpade,
)
from shineon_tpu.ops import fused_attention as jfa
from shineon_tpu_torch import convert
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.networks.attention import SelfAttention
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.sams.attentive_multispade import AttentiveMultiSpade
from shineon_tpu_torch.networks.sams.multispade import MultiSpade
from shineon_tpu_torch.networks.sams.sams_generator import SamsGenerator, choose_spade
from shineon_tpu_torch.ops import fused_attention as tfa
from shineon_tpu_torch.ops.fused_spade import error_ratio
from shineon_tpu_torch.options import sams_options
from test_torch_networks import (  # noqa: F401 (one_torch_thread: autouse)
    LABELS,
    _assert_rel,
    _assert_stats,
    _np,
    _spade_inputs,
    _t,
    _with_random_stats,
    one_torch_thread,
)


def with_nonzero_gamma(variables, seed):
    """Every SelfAttention gamma of a flax variable tree set to N(0.5, 0.1)."""
    rng = np.random.RandomState(seed)

    def f(path, v):
        if jax.tree_util.keystr(path).endswith("['gamma']"):
            return (0.5 + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(f, dict(variables))


def _qkv(seed, B=2, N=100, d=16, dv=64, score_std=2.0):
    """numpy q, k (B, N, d) and v (B, N, dv), with scores q.k of std about
    ``score_std`` (peaked rows at 2: the largest weight of a row is far from
    1/N)."""
    rng = np.random.RandomState(seed)
    sigma = np.sqrt(score_std / np.sqrt(d))
    q = (sigma * rng.randn(B, N, d)).astype(np.float32)
    k = (sigma * rng.randn(B, N, d)).astype(np.float32)
    v = rng.randn(B, N, dv).astype(np.float32)
    return q, k, v


_DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


# ------------------------------------------------------------------- the op

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [12, 100, 256])
def test_attention_plain_matches_jax_reference(N, dtype):
    """attention_plain and the CPU wrapper against _attention_reference, the
    JAX package's einsum path (and its sagan_attention on the CPU), element
    by element: |diff| <= tol * (|ref| + rms(ref)) with tol 1e-5 in f32
    (sums in another order) and 2^-7 in bf16 (both sides round the
    probabilities and the output to bf16 at the same places; an f32 ulp of
    difference before a rounding may flip it, one bf16 ulp of the output is
    2^-8 of |ref|). The wrapper launches nothing on CPU tensors."""
    tdt, jdt = _DTYPES[dtype]
    q, k, v = _qkv(N, N=N)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    refs = [jfa._attention_reference(jq, jk, jv), jfa.sagan_attention(jq, jk, jv)]
    before = tfa.sagan_attention.launches
    outs = [tfa.attention_plain(tq, tk, tv), tfa.sagan_attention(tq, tk, tv)]
    assert tfa.sagan_attention.launches == before
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for out in outs:
        assert out.dtype == tdt and tuple(out.shape) == (2, N, 64)
        for ref in refs:
            ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
            assert error_ratio(out, ref) <= tol


def test_attention_plain_matches_pallas_interpret(monkeypatch):
    """The Pallas kernel body (_pallas_attention_single, query tiles of 128,
    K and V resident, f32 inside) run in interpret mode, f32, N = 256:
    |diff| <= 1e-5 * (|ref| + rms(ref)) at every element."""
    monkeypatch.setattr(jfa.pl, "pallas_call",
                        functools.partial(jfa.pl.pallas_call, interpret=True))
    q, k, v = _qkv(7, N=256, d=16, dv=128)
    out = tfa.attention_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    for b in range(q.shape[0]):
        ref = jfa._pallas_attention_single(jnp.asarray(q[b]), jnp.asarray(k[b]),
                                           jnp.asarray(v[b]), 128)
        assert error_ratio(out[b], torch.from_numpy(np.array(ref))) <= 1e-5


def test_sagan_attention_grad_matches_jax():
    """SaganAttention's backward (f32 recompute) against jax.grad through
    the JAX package's custom_vjp, f32, N = 100: each gradient within 1e-5 of
    its max."""
    q, k, v = _qkv(8, N=100, d=16, dv=64)
    w = np.random.RandomState(9).randn(2, 100, 64).astype(np.float32)
    grads_ref = jax.grad(lambda a, b, c: jnp.sum(jfa.sagan_attention(a, b, c) * w),
                         argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (tfa.sagan_attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for mine, ref in zip((tq.grad, tk.grad, tv.grad), grads_ref):
        _assert_rel(mine.numpy(), np.asarray(ref), 1e-5)


def test_kernel_rejects_unsupported_shapes():
    """The CUDA path validates before it builds or launches, and raises (no
    fall back to the plain version) on what the kernel does not take: mixed
    dtypes, k or v of another shape than q's, a dtype the kernel does not
    write, an empty dimension. Any d and dv are taken."""
    z = torch.zeros
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        tfa._launch(z(1, 12, 24), z(1, 12, 24, dtype=torch.bfloat16), z(1, 12, 64))
    with pytest.raises(ValueError, match="k has shape"):
        tfa._launch(z(1, 12, 24), z(1, 12, 16), z(1, 12, 64))
    with pytest.raises(ValueError, match="v has shape"):
        tfa._launch(z(1, 12, 24), z(1, 12, 24), z(1, 10, 64))
    with pytest.raises(ValueError, match="not supported"):
        tfa._launch(*(z(1, 12, 8, dtype=torch.float16) for _ in range(3)))
    with pytest.raises(ValueError, match="empty"):
        tfa._launch(z(1, 12, 0), z(1, 12, 0), z(1, 12, 64))


@pytest.mark.parametrize("d,dv", [(8, 64), (108, 864)])
def test_attention_plain_matches_jax_at_repaired_widths(d, dv):
    """The widths the first kernel refused: d = 8 (SAMS attention at 64
    channels) and d = 108, dv = 864 (TOM's U-Net attention at 2 frames),
    f32 and bf16 against _attention_reference with the tolerances of
    test_attention_plain_matches_jax_reference."""
    q, k, v = _qkv(d, N=40, d=d, dv=dv)
    for dtype in ("float32", "bfloat16"):
        tdt, jdt = _DTYPES[dtype]
        ref = jfa._attention_reference(*(jnp.asarray(a, jdt) for a in (q, k, v)))
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
        out = tfa.sagan_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
        assert error_ratio(out, ref) <= (1e-5 if dtype == "float32" else 2.0 ** -7)


@pytest.mark.parametrize("d,dv", [(8, 64), (108, 864), (13, 5)])
def test_width_padding_is_exact(d, dv):
    """q, k and v zero-padded to the bf16 kernel's multiples of 8 give the
    plain version's output in its first dv columns, to f32 rounding (the
    zero terms may change the order of the matrix products' sums, not
    their value), and zeros past them."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, N=30, d=d, dv=dv))
    qp, kp, vp = (tfa._pad_last(t, tfa.ROW_STEP) for t in (q, k, v))
    assert qp.shape[-1] % 8 == 0 and vp.shape[-1] % 8 == 0
    out = tfa.attention_plain(qp, kp, vp)
    assert error_ratio(out[..., :dv], tfa.attention_plain(q, k, v)) <= 1e-6
    assert not out[..., dv:].any()


# ---------------------------------------------------------------- the blocks

def test_self_attention_matches_jax():
    """SelfAttention (N(0, .02) 1x1 convs, gamma 0.5-ish), f32, 6x5 tokens,
    64 channels: within 1e-5 of max|ref|, and unlike x (the block is not
    the identity)."""
    x = np.random.RandomState(10).randn(2, 6, 5, 64).astype(np.float32)
    jm = JSelfAttention()
    variables = with_nonzero_gamma(_np(jm.init(jax.random.PRNGKey(11), x)), 12)
    ref = np.asarray(jm.apply(variables, x))
    tm = SelfAttention(64)
    convert.load_flax(tm, variables, ())
    with torch.no_grad():
        out = tm(_t(x)).numpy()
    _assert_rel(out, ref, 1e-5)
    assert np.abs(out - x).max() > 0.01 * np.abs(x).max()


def _attentive_pair(seed):
    x, seg = _spade_inputs(seed)
    jm = JAttentiveMultiSpade(config_text="spadesyncbatch3x3")
    variables = _with_random_stats(
        _np(jm.init(jax.random.PRNGKey(seed + 1), x, seg, train=True)), seed + 2)
    variables = with_nonzero_gamma(variables, seed + 3)
    tm = AttentiveMultiSpade(32, LABELS, config_text="spadesyncbatch3x3")
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    return x, seg, jm, variables, tm


@pytest.mark.parametrize("train", [False, True])
def test_attentive_multispade_matches_jax(train, monkeypatch):
    """Four labels' SPADEs on the same x, concatenated (128 channels),
    attended (120 tokens) and reduced by mlp_final: at eval one one-label
    chain a label (the JAX side fused too), in training the block-diagonal
    hidden conv and the running-stat update. f32, within 1e-5 of max|ref|."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    x, seg, jm, variables, tm = _attentive_pair(20)
    ref, upd = jm.apply(variables, x, seg, train=train, mutable=["batch_stats"])
    calls = []
    real = tfa.sagan_attention

    def spy(*a):
        calls.append(tuple(a[0].shape) + (a[2].shape[-1],))
        return real(*a)

    monkeypatch.setattr("shineon_tpu_torch.networks.attention.sagan_attention", spy)
    with torch.no_grad():
        out = tm(_t(x), {k: _t(v) for k, v in seg.items()}, train=train)
    assert calls == [(2, 12 * 10, 16, 128)]
    _assert_rel(out.numpy(), ref, 1e-5)
    _assert_stats(tm, upd["batch_stats"], convert.GENERATOR_RENAMES)


def test_gamma_zero_blinds_the_block_to_attention():
    """With gamma = 0 the eval output does not move when the value conv's
    weights change (the attention is invisible); with the gamma these tests
    set, it does. So a parity test at gamma = 0 would pass with any kernel."""
    x, seg, _, _, tm = _attentive_pair(30)
    tx, tseg = _t(x), {k: _t(v) for k, v in seg.items()}
    vw = tm.attention_layer.value_conv.weight
    with torch.no_grad():
        for gamma, moves in ((0.0, False), (0.5, True)):
            tm.attention_layer.gamma.fill_(gamma)
            a = tm(tx, tseg, train=False)
            vw.mul_(2.0)
            b = tm(tx, tseg, train=False)
            vw.div_(2.0)
            assert bool((a - b).abs().max() > 0) == moves


def test_choose_spade_placement():
    """Positive and negative string indices name the same block."""
    assert choose_spade(("-1",), 2, 3) is AttentiveMultiSpade
    assert choose_spade(("2",), 2, 3) is AttentiveMultiSpade
    assert choose_spade(("-1",), 1, 3) is MultiSpade
    assert choose_spade((), 0, 3) is MultiSpade


# ------------------------------------------------------------- the generator

def _generator_case(seed, n_frames=3, **cfg):
    rng = np.random.RandomState(seed)
    B, H, W = 2, 32, 24
    prev = rng.randn(B, n_frames - 1, H, W, 3).astype(np.float32)
    maps = rng.randn(B, n_frames - 1, H, W, 2).astype(np.float32)
    cur = {k: rng.randn(B, H, W, c).astype(np.float32) for k, c in LABELS.items()}
    cfg = dict(dict(ngf_pow_outer=3, ngf_pow_inner=5, num_middle=1, n_frames_total=n_frames,
                    flow_warp=True, encoder_input="flow", inputs=tuple(LABELS)), **cfg)
    jm = JSamsGenerator(**cfg)
    variables = _with_random_stats(
        _np(jm.init(jax.random.PRNGKey(seed + 1), prev, maps, cur, train=True)), seed + 2)
    return prev, maps, cur, cfg, jm, with_nonzero_gamma(variables, seed + 3)


_PLACEMENTS = {
    # the last middle block (4x3 tokens) and decoder block 0 (8x6 tokens)
    "middle-1_decoder0": dict(attention_middle_indices=("-1",), attention_decoder_indices=("0",)),
    # widths step by 4x, so decode_extra exists and turns attentive too
    "decode_extra": dict(attention_decoder_indices=("-1",), ngf_pow_inner=6, ngf_pow_step=2),
}


@pytest.mark.parametrize("train,placement", [(False, "middle-1_decoder0"),
                                             (True, "middle-1_decoder0"),
                                             (False, "decode_extra")])
def test_sams_generator_attention_matches_jax(train, placement, monkeypatch):
    """SamsGenerator at tiny widths with attention blocks, 3-frame clips,
    flow-warp output: eval (every SPADE site fused) and train (stats and u
    updated), f32, within 1e-4 of max|ref|; the whole converted tree loads
    with strict=True."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    prev, maps, cur, cfg, jm, variables = _generator_case(40, **_PLACEMENTS[placement])
    ref, upd = jm.apply(variables, prev, maps, cur, train=train, update_stats=train,
                        mutable=["batch_stats"])
    tm = SamsGenerator(**cfg)
    attentive = [n for n, m in tm.named_modules() if isinstance(m, AttentiveMultiSpade)]
    expect = {"middle-1_decoder0": ["middle_0.spade_0", "middle_0.spade_1", "decode_0.norm_s",
                                    "decode_0.spade_0", "decode_0.spade_1"],
              "decode_extra": ["decode_1.norm_s", "decode_1.spade_0", "decode_1.spade_1",
                               "decode_extra.norm_s", "decode_extra.spade_0",
                               "decode_extra.spade_1"]}[placement]
    assert attentive == expect
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    with torch.no_grad():
        out = tm(_t(prev), _t(maps), {k: _t(v) for k, v in cur.items()},
                 train=train, update_stats=train)
    assert out.shape == (2, 32, 24, 4)
    _assert_rel(out.numpy(), ref, 1e-4)
    _assert_stats(tm, upd["batch_stats"], convert.GENERATOR_RENAMES, tol=1e-4)


def test_sams_generator_attention_bf16_matches_jax(monkeypatch):
    """The attention generator in bf16 at eval (the serving dtype), the same
    weights and bf16 inputs on both sides: within 2e-2 of max|ref| of JAX,
    and under a quarter of the attention blocks' own effect on the output
    (the port's output with every gamma zeroed), so the limit tells bf16
    rounding from a missing attention. (At this seed: 0.0077 against an
    effect of 0.066.)"""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    prev, maps, cur, cfg, _, variables = _generator_case(60, **_PLACEMENTS["middle-1_decoder0"])
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    ref = JSamsGenerator(**cfg, dtype=jnp.bfloat16).apply(
        variables, jb(prev), jb(maps), {k: jb(v) for k, v in cur.items()}, train=False)
    ref = np.asarray(ref.astype(jnp.float32))
    tm = SamsGenerator(**cfg, dtype=torch.bfloat16)
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    tb = lambda a: _t(a).to(torch.bfloat16)  # noqa: E731
    outs = []
    with torch.no_grad():
        for _ in range(2):
            out = tm(tb(prev), tb(maps), {k: tb(v) for k, v in cur.items()}, train=False)
            assert out.dtype == torch.bfloat16
            outs.append(out.float().numpy())
            for m in tm.modules():
                if isinstance(m, SelfAttention):
                    m.gamma.zero_()
    err, effect = (float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in ((outs[0], ref), (outs[1], outs[0])))
    assert err <= 2e-2
    assert err < 0.25 * effect, (err, effect)


def test_int8_generator_attention_matches_jax(monkeypatch):
    """The attention generator in int8 serving (quantized chains, int8 3x3
    resblock convs at min channels 8; mlp_final and the 1x1 attention convs
    stay fp on both sides), 5-frame clips: within 2e-3 of max|ref| of JAX
    and under a quarter of the int8-vs-fp distance (on the port's fp
    generator), as the generator without attention is held
    (tests/test_torch_int8.py)."""
    prev, maps, cur, cfg, jm, variables = _generator_case(
        50, n_frames=5, **_PLACEMENTS["middle-1_decoder0"])
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    monkeypatch.setenv("SHINEON_INT8_SPADE", "1")
    monkeypatch.setenv("SHINEON_INT8_MIN_CH", "8")
    ref = np.asarray(jm.apply(variables, prev, maps, cur, train=False))
    outs = {}
    for q in (True, False):
        tm = SamsGenerator(**cfg, int8=q, int8_min_channels=8)
        assert not any(m.mlp_final.int8 for m in tm.modules()
                       if isinstance(m, AttentiveMultiSpade))
        convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
        with torch.no_grad():
            outs[q] = tm(_t(prev), _t(maps), {k: _t(v) for k, v in cur.items()},
                         train=False).numpy()
    err, gap = (float(np.abs(outs[q] - ref).max() / np.abs(ref).max()) for q in (True, False))
    assert err <= 2e-3
    assert err < 0.25 * gap, (err, gap)


def test_init_weights_follows_jax_rules():
    """SamsModel.init_weights on an attention generator: the attention 1x1
    convs N(0, 0.02) with zero biases, gamma 0, mlp_final and the other
    convs lecun-normal (std sqrt(1/fan_in))."""
    opt = sams_options(fine_height=32, fine_width=24, n_frames_total=3, n_frames_now=3,
                       ngf_pow_outer=3, ngf_pow_inner=5, num_middle=1, precision=32,
                       attention_middle_indices=("-1",), attention_decoder_indices=("0",))
    model = SamsModel(opt, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    blocks = [m for m in model.generator.modules() if isinstance(m, SelfAttention)]
    assert len(blocks) == 5
    att_weights = torch.cat([c.weight.flatten() for b in blocks for c in b.convs()])
    assert abs(att_weights.std().item() - 0.02) < 0.002
    for b in blocks:
        assert b.gamma.item() == 0.0
        assert all((c.bias == 0).all() for c in b.convs())
    finals = [m.mlp_final for m in model.generator.modules()
              if isinstance(m, AttentiveMultiSpade)]
    for conv in finals + [model.generator.encode_conv_in]:
        fan_in = conv.weight[0].numel()
        assert isinstance(conv, Conv2d)
        assert abs(conv.weight.std().item() * fan_in ** 0.5 - 1.0) < 0.15

