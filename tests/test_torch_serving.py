"""The port's whole serving clip (shineon_tpu_torch/serving.py) against the
JAX clip of bench.py::build_inference on the CPU: 128x96, 3-frame clips,
batch 2, widths 2^3..2^5 with one middle block, f32, the same weights
(made in JAX, carried across with shineon_tpu_torch.convert) and the same
raw batch. The JAX side takes the fused chain at every SPADE site
(SHINEON_FUSED_SPADE=1, its CPU reference formulation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _raw_batch, _sams_opt
from shineon_tpu.models.sams_model import SamsModel as JSamsModel
from shineon_tpu.models.warp_model import WarpModel as JWarpModel
from shineon_tpu.ops import grid_sample as j_grid_sample
from shineon_tpu_torch import convert
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.models.warp_model import WarpModel
from shineon_tpu_torch.options import sams_options, warp_options
from shineon_tpu_torch.serving import make_one_clip, synthetic_raw_batch, warm_up
from test_torch_attention import with_nonzero_gamma
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)

TINY = dict(fine_height=128, fine_width=96, n_frames_total=3, n_frames_now=3,
            ngf_pow_outer=3, ngf_pow_inner=5, num_middle=1, ngf=8, precision=32,
            batch_size=2)
# attention in the last middle block (32x24, 768 tokens) and decoder block
# 0 (64x48, 3072 tokens, the decoder resolution of the production clip's
# attention)
TINY_ATTENTION = dict(attention_middle_indices=("-1",), attention_decoder_indices=("0",))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_rel(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / np.abs(ref).max()


def _jax_clip(sams, warp):
    """bench.py::build_inference.one_clip, at the tiny options."""

    def one_clip(warp_vars, g_params, g_stats, batch):
        feats = sams.features(batch)
        person = jnp.concatenate([feats["agnostic"][:, -1], feats["densepose"][:, -1]], -1)
        cloth_in = feats["cloth"][:, -1]
        grid, _ = warp.gmm.apply(warp_vars, person, cloth_in, train=False)
        warped = j_grid_sample(cloth_in, grid, padding_mode="border")
        feats = dict(feats)
        feats["cloth"] = feats["cloth"].at[:, -1].set(warped)
        return sams.generate_n_frames(g_params, g_stats, feats, train=False)[2]

    return jax.jit(one_clip)


def test_raw_batch_matches_jax_layout():
    """The port's synthetic batch is the JAX package's _raw_batch."""
    opt = _sams_opt(**TINY)
    ref = _raw_batch(opt, batch=2)
    out = synthetic_raw_batch(sams_options(**TINY), 2)
    assert sorted(out) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k].numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("attention", [False, True], ids=["plain", "attention"])
def test_serving_clip_matches_jax(attention, monkeypatch):
    """One warm-up rollout updates the same running statistics and spectral
    u (max rel 1e-4), and the eval clip then gives the same frames
    (max |diff| <= 1e-3 * max |ref|: f32 sums in another order through
    ~20 conv layers and 3 autoregressive frames). With ``attention`` the
    generator has attention blocks (TINY_ATTENTION), every gamma nonzero."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    tiny = {**TINY, **(TINY_ATTENTION if attention else {})}
    jsams = JSamsModel(_sams_opt(is_train=False, **tiny))
    jwarp = JWarpModel(_sams_opt(is_train=False, model="warp", flow_warp=False, grid_size=5,
                                 person_inputs=["agnostic", "densepose"], **TINY))
    g = jsams.init_state(jax.random.PRNGKey(420), 1).nets["generator"]
    w = jwarp.init_state(jax.random.PRNGKey(7), 1).nets["gmm"]
    warp_vars = {"params": w.params, **w.stats}
    params = with_nonzero_gamma(_np(g.params), 421) if attention else g.params

    sams = SamsModel(sams_options(**tiny), device="cpu")
    warp = WarpModel(warp_options(**TINY), device="cpu")
    convert.load_flax(sams.generator, _np({"params": params, **g.stats}),
                      convert.GENERATOR_RENAMES)
    convert.load_flax(warp.gmm, _np(warp_vars), convert.GMM_RENAMES)

    raw = _raw_batch(_sams_opt(**TINY), batch=2)
    jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in raw.items()}

    # warm-up: one train-mode rollout on each side
    feats = jax.jit(jsams.features)(jbatch)
    stats = jax.jit(
        lambda p, s, f: jsams.generate_n_frames(p, s, f, train=True)[3]
    )(params, g.stats, feats)
    warm_up(sams, tbatch, rollouts=1)
    ref_stats = convert.flax_to_state_dict(_np(stats), convert.GENERATOR_RENAMES)
    mine = sams.generator.state_dict()
    assert ref_stats
    for name, value in ref_stats.items():
        assert _max_rel(mine[name].numpy(), value.numpy()) <= 1e-4, name

    ref = _jax_clip(jsams, jwarp)(warp_vars, params, stats, jbatch)
    out = make_one_clip(warp, sams)(tbatch)
    assert out.shape == (2, 3, 128, 96, 3) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    assert _max_rel(out.numpy(), ref) <= 1e-3


def test_build_inference_cpu_runs_small_clip():
    """build_inference on an explicit CPU device: warmed, finite frames of
    the expected shape, and no kernel launch (CPU tensors take the plain
    version)."""
    from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate
    from shineon_tpu_torch.serving import build_inference

    before = fused_multispade_modulate.launches
    one_clip, warp, sams, raw, n_frames = build_inference(
        2, device="cpu", **{k: v for k, v in TINY.items() if k != "batch_size"})
    frames = one_clip(raw)
    assert n_frames == 3
    assert frames.shape == (2, 3, 128, 96, 3)
    assert torch.isfinite(frames).all()
    assert fused_multispade_modulate.launches == before

