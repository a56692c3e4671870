"""The fused MultiSPADE chain's hidden activations other than relu (gelu in
its tanh form, swish, sine = sin(30 v): ``--activation``) against the JAX
package on the CPU: the plain chain, full precision and quantized, against
shineon_tpu/ops/fused_spade.py's reference formulation (and, f32, its
Pallas kernel in interpret mode), and the tiny serving clip per activation
against the JAX clip, as tests/test_torch_serving.py holds relu's.

In bf16 both sides round as the JAX package's XLA formulation does: the
conv's sum to bf16, plus the bias in bf16, the activation of that value,
rounded to bf16 again. The hand-written kernels take the same values on
the card (chip_smoke.py phase 10a)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _raw_batch, _sams_opt
from shineon_tpu.models.sams_model import SamsModel as JSamsModel
from shineon_tpu.models.warp_model import WarpModel as JWarpModel
from shineon_tpu.networks.sams.multispade import MultiSpade as JMultiSpade
from shineon_tpu.networks.sams.spade import AnySpadeResBlock as JResBlock
from shineon_tpu.ops import fused_spade as jfs
from shineon_tpu_torch import convert
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.models.warp_model import WarpModel
from shineon_tpu_torch.networks.sams.multispade import MultiSpade
from shineon_tpu_torch.networks.sams.spade import AnySpadeResBlock
from shineon_tpu_torch.ops import fused_spade as tfs
from shineon_tpu_torch.options import sams_options, warp_options
from shineon_tpu_torch.serving import make_one_clip, warm_up
from test_torch_fused_spade import _jax_args, _make_case, _max_rel, _torch_args
from test_torch_networks import (  # noqa: F401 (one_torch_thread: autouse)
    LABELS,
    _assert_rel,
    _spade_inputs,
    _t,
    _with_random_stats,
    one_torch_thread,
)
from test_torch_serving import TINY, _jax_clip, _np

ACTIVATIONS = ("gelu", "swish", "sine")


@pytest.mark.parametrize("act", ACTIVATIONS)
@pytest.mark.parametrize("L", [1, 4])
def test_plain_chain_matches_jax_f32(act, L):
    """f32: the plain chain against the JAX reference formulation and its
    Pallas kernel in interpret mode, atol 2e-4 (relu's limit, the JAX
    package's own kernel-vs-reference tolerance)."""
    case = _make_case(L=L, seed=30 + L)
    jargs = _jax_args(case, jnp.float32)
    out = tfs.multispade_modulate_plain(*_torch_args(case, torch.float32), act_name=act)
    ref = jfs.multispade_modulate_reference(*jargs, act_name=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-4)
    x, ab, segs, wshs, bshs, wgbs, bgbs = jargs
    packed = jfs._pack_inputs(segs, wshs, bshs, wgbs, bgbs, jnp.float32)
    ref = jfs._fused_forward(x, ab, *packed, act, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=2e-4)


@pytest.mark.parametrize("act", ACTIVATIONS)
def test_plain_chain_matches_jax_bf16(act):
    """bf16 end to end: max |diff| <= 3e-2 max |ref|, relu's limit (both
    round the hidden map and the conv outputs to bf16, where XLA's and
    PyTorch's CPU convolutions sum in other orders)."""
    case = _make_case(L=4, seed=40)
    ref = jfs.multispade_modulate_reference(*_jax_args(case, jnp.bfloat16), act_name=act)
    ref = np.asarray(ref.astype(jnp.float32))
    targs = _torch_args(case, torch.bfloat16)
    out = tfs.multispade_modulate_plain(*targs, act_name=act)
    assert out.dtype == torch.bfloat16
    err = _max_rel(out.float().numpy(), ref)
    assert err <= 3e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ACTIVATIONS)
def test_plain_int8_chain_matches_jax(act, dtype):
    """The quantized chain: the plain version against the JAX reference's
    int8 formulation, and the wrapper (CPU: the plain version) against the
    JAX fused op, within the int8 limits for the activation
    (int8_chain_agrees: elementwise and rms)."""
    case = _make_case(L=4, seed=50)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jargs, targs = _jax_args(case, jdt), _torch_args(case, dtype)
    pairs = [(tfs.multispade_modulate_plain_int8(*targs, act_name=act),
              jfs.multispade_modulate_reference_int8(*jargs, act_name=act)),
             (tfs.fused_multispade_modulate(*targs, act_name=act, quantized=True),
              jfs.fused_multispade_modulate(*jargs, act_name=act, quantized=True))]
    for out, ref in pairs:
        assert out.dtype == dtype
        ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).to(dtype)
        ok, ratio, rms = tfs.int8_chain_agrees(out, ref, act)
        assert ok, (ratio, rms)


def test_activation_codes_and_refusal():
    """The kernels' activation codes (csrc/fused_multispade.cu, enum Act)
    and the plain version's functions: relu, gelu (tanh form), swish and
    sin(30 v); an unknown activation raises in both versions."""
    assert tfs.ACTIVATIONS == ("relu", "gelu", "swish", "sine")
    v = torch.linspace(-3, 3, 61)
    torch.testing.assert_close(tfs._act("gelu")(v), torch.nn.functional.gelu(
        v, approximate="tanh"))
    torch.testing.assert_close(tfs._act("swish")(v), v * torch.sigmoid(v))
    torch.testing.assert_close(tfs._act("sine")(v), torch.sin(30 * v))
    args = _torch_args(_make_case(B=1, H=5, W=4, C=8, L=1, seed=1), torch.float32)
    with pytest.raises(RuntimeError, match="activation"):
        tfs.multispade_modulate_plain(*args, act_name="tanh")
    x, ab, segs, wshs, bshs, wgbs, bgbs = args
    with pytest.raises(ValueError, match="activation"):
        tfs._launch(x, ab, tfs.kernel_segmap(segs, x.dtype),
                    tfs.pack_weights(wshs, bshs, wgbs, bgbs, x.dtype), "tanh")


@functools.lru_cache(maxsize=None)
def _jax_initial_states():
    """The JAX package's generator state at TINY (an activation has no
    parameters: one draw serves every activation) and its GMM with the
    warp model, as test_torch_serving draws them."""
    g = JSamsModel(_sams_opt(is_train=False, **TINY)).init_state(
        jax.random.PRNGKey(420), 1).nets["generator"]
    jwarp = JWarpModel(_sams_opt(is_train=False, model="warp", flow_warp=False, grid_size=5,
                                 person_inputs=["agnostic", "densepose"], **TINY))
    w = jwarp.init_state(jax.random.PRNGKey(7), 1).nets["gmm"]
    return g, jwarp, {"params": w.params, **w.stats}


@pytest.mark.parametrize("act", ("gelu", "swish"))
def test_serving_clip_matches_jax(act, monkeypatch):
    """The tiny serving clip (test_torch_serving's TINY, f32, fused chain at
    every SPADE site on both sides) with ``activation=act``: one warm-up
    rollout on each side, then the eval clip within relu's limit, max |diff|
    <= 1e-3 max |ref|. (Sine: test_sine_res_block_matches_jax.)"""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    tiny = dict(TINY, activation=act)
    jsams = JSamsModel(_sams_opt(is_train=False, **tiny))
    g, jwarp, warp_vars = _jax_initial_states()
    sams = SamsModel(sams_options(**tiny), device="cpu")
    warp = WarpModel(warp_options(**TINY), device="cpu")
    convert.load_flax(sams.generator, _np({"params": g.params, **g.stats}),
                      convert.GENERATOR_RENAMES)
    convert.load_flax(warp.gmm, _np(warp_vars), convert.GMM_RENAMES)

    raw = _raw_batch(_sams_opt(**TINY), batch=2)
    jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in raw.items()}
    feats = jax.jit(jsams.features)(jbatch)
    stats = jax.jit(lambda p, s, f: jsams.generate_n_frames(p, s, f, train=True)[3])(
        g.params, g.stats, feats)
    warm_up(sams, tbatch, rollouts=1)

    ref = np.asarray(_jax_clip(jsams, jwarp)(warp_vars, g.params, stats, jbatch))
    out = make_one_clip(warp, sams)(tbatch)
    assert out.shape == (2, 3, 128, 96, 3) and torch.isfinite(out).all()
    assert _max_rel(out.numpy(), ref) <= 1e-3


def test_sine_res_block_matches_jax(monkeypatch):
    """--activation sine in a spectral SPADE resblock over MultiSpade in
    eval: the fused chain with sine hidden maps (the MultiSpade alone agrees
    to 1e-6 of its largest entry), then the block's own sin(30 x) and its
    convs, against the JAX block: max |diff| <= 2e-3 max |ref|. That
    sin(30 x) takes SPADE outputs up to ~50, where one f32 ulp moves it by
    30 ulp: the JAX block itself moves by 1.2e-4 (8.8e-4) of its largest
    entry under a 1e-7 (1e-6) relative change of its input (a CPU run), and
    a fault (another frequency, a missed rounding) moves it by O(1). The
    whole clip is not compared: its ~20 layers of sin(30 x) make it
    chaotic at random weights, where the JAX clip moves by 0.94 of its
    largest entry in the first frame under a 1e-6 relative change of
    encode_conv_in's kernel (TINY, a CPU run)."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    x, seg = _spade_inputs(60)
    jm = JResBlock(fin=32, fout=16, norm_G="spectralspadesyncbatch3x3", spade_ctor=JMultiSpade,
                   activation="sine")
    variables = _with_random_stats(_np(jm.init(jax.random.PRNGKey(61), x, seg, train=True)), 62)
    ref = jm.apply(variables, x, seg, train=False)
    tm = AnySpadeResBlock(32, 16, "spectralspadesyncbatch3x3", activation="sine",
                          make_spade=lambda c: MultiSpade(c, LABELS, "spadesyncbatch3x3",
                                                          activation="sine"))
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    with torch.no_grad():
        out = tm(_t(x), {k: _t(v) for k, v in seg.items()}, train=False)
    _assert_rel(out.numpy(), ref, 2e-3)
