"""The port's networks against the JAX package's flax modules on the CPU:
weights made in JAX and carried across with shineon_tpu_torch.convert,
inputs from a numpy seed, f32."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shineon_tpu.networks.cpvton.warp import GMM as JGMM
from shineon_tpu.networks.normalization import SyncBatchNorm as JSyncBatchNorm
from shineon_tpu.networks.sams import SamsGenerator as JSamsGenerator
from shineon_tpu.networks.sams.multispade import MultiSpade as JMultiSpade
from shineon_tpu.networks.sams.spade import SPADE as JSPADE
from shineon_tpu.networks.sams.spade import AnySpadeResBlock as JResBlock
from shineon_tpu_torch import convert
from shineon_tpu_torch.networks.cpvton.warp import GMM
from shineon_tpu_torch.networks.normalization import SpectralConv2d, SyncBatchNorm
from shineon_tpu_torch.networks.sams import spade as tspade
from shineon_tpu_torch.networks.sams.multispade import MultiSpade
from shineon_tpu_torch.networks.sams.sams_generator import SamsGenerator
from shineon_tpu_torch.networks.sams.spade import SPADE, AnySpadeResBlock

LABELS = {"agnostic": 4, "cloth": 3, "densepose": 3, "flow": 2}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for each module that imports this fixture: its
    tensors are small, and under the suite's parallel workers torch's
    spinning threads fight for the cores (a clip that takes 4 s alone took
    223 s there)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_random_stats(variables, seed):
    """Replace running means/vars with random values so eval-mode norms
    are not the identity."""
    rng = np.random.RandomState(seed)

    def f(path, v):
        name = jax.tree_util.keystr(path)
        if name.endswith("['mean']"):
            return (0.2 * rng.randn(*v.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return np.asarray(v)

    return jax.tree_util.tree_map_with_path(f, dict(variables))


def _assert_rel(out, ref, tol):
    """max |out - ref| <= tol * max |ref|."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= tol, err


def _assert_stats(module, jax_stats, renames, tol=1e-5):
    """Every converted JAX batch_stats entry equals the module's buffer."""
    mine = module.state_dict()
    for name, value in convert.flax_to_state_dict({"batch_stats": jax_stats}, renames).items():
        _assert_rel(mine[name].numpy(), value.numpy(), tol)


@pytest.mark.parametrize("train", [False, True])
def test_sync_batch_norm(train):
    """Affine batch norm with N(1, .02) scales, eval and train, including
    the running-stat update: rtol 1e-5."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5, 3, 6).astype(np.float32) * 2 + 1
    jm = JSyncBatchNorm(init_gain=0.02)
    variables = _with_random_stats(_np(jm.init(jax.random.PRNGKey(0), x, use_running_average=True)), 1)
    tm = SyncBatchNorm(6)
    convert.load_flax(tm, variables, ())
    ref, upd = jm.apply(variables, x, use_running_average=not train, mutable=["batch_stats"])
    with torch.no_grad():
        out = tm(_t(x), use_running_average=not train)
    _assert_rel(out.numpy(), ref, 1e-5)
    _assert_stats(tm, upd["batch_stats"], ())


class _JSpectral(fnn.Module):
    @fnn.compact
    def __call__(self, x, update_stats):
        conv = fnn.Conv(8, (3, 3), padding=((1, 1), (1, 1)), name="conv")
        return fnn.SpectralNorm(conv)(x, update_stats=update_stats)


class _TSpectral(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = SpectralConv2d(5, 8, 3, padding=1)

    def forward(self, x, update_stats):
        return self.conv(x, update_stats=update_stats)


@pytest.mark.parametrize("update_stats", [False, True])
def test_spectral_norm_flax_exact(update_stats):
    """One power step from the stored u at every call, u and sigma stored
    only when updating: outputs and state within rtol 1e-5, over two calls
    (under torch.no_grad the eval call reuses its cached kernel)."""
    x = np.random.RandomState(2).randn(2, 6, 5, 5).astype(np.float32)
    jm = _JSpectral()
    variables = _np(jm.init(jax.random.PRNGKey(3), x, update_stats=False))
    tm = _TSpectral()
    convert.load_flax(tm, variables, ())
    for _ in range(2):
        ref, upd = jm.apply(variables, x, update_stats=update_stats, mutable=["batch_stats"])
        variables = {**variables, **_np(upd)}
        with torch.no_grad():
            out = tm(_t(x), update_stats)
        _assert_rel(out.numpy(), ref, 1e-5)
        _assert_stats(tm, variables["batch_stats"], ())


def _spade_inputs(seed, C=32, H=12, W=10):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, H, W, C).astype(np.float32)
    seg = {k: rng.randn(2, 2 * H, 2 * W, c).astype(np.float32) for k, c in LABELS.items()}
    return x, seg


@pytest.mark.parametrize("train", [False, True])
def test_spade(train, monkeypatch):
    """Single-label SPADE (segmap at twice x's size, torch-nearest resize):
    eval through the fused path, train conv by conv. rtol 1e-5."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    x, seg = _spade_inputs(4)
    s = seg["agnostic"]
    jm = JSPADE(config_text="spadesyncbatch3x3")
    variables = _with_random_stats(_np(jm.init(jax.random.PRNGKey(5), x, s, train=True)), 6)
    if train:
        ref, upd = jm.apply(variables, x, s, train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, x, s, train=False, mode="apply_fused")
    tm = SPADE(32, 4, config_text="spadesyncbatch3x3")
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    with torch.no_grad():
        out = tm(_t(x), _t(s), train=True) if train else tm.forward_fused(_t(x), _t(s))
    _assert_rel(out.numpy(), ref, 1e-5)
    if train:
        _assert_stats(tm, upd["batch_stats"], convert.GENERATOR_RENAMES)


@pytest.mark.parametrize("train", [False, True])
def test_multispade(train, monkeypatch):
    """Four labels in sorted order: at eval ONE chain call for all labels,
    in training the block-diagonal hidden conv. rtol 1e-5."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    x, seg = _spade_inputs(7)
    jm = JMultiSpade(config_text="spadesyncbatch3x3")
    variables = _with_random_stats(_np(jm.init(jax.random.PRNGKey(8), x, seg, train=True)), 9)
    ref, upd = jm.apply(variables, x, seg, train=train, mutable=["batch_stats"])
    tm = MultiSpade(32, LABELS, config_text="spadesyncbatch3x3")
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    calls = []
    real = tspade.fused_multispade_modulate
    monkeypatch.setattr(tspade, "fused_multispade_modulate",
                        lambda *a, **k: calls.append(len(a[2])) or real(*a, **k))
    with torch.no_grad():
        out = tm(_t(x), {k: _t(v) for k, v in seg.items()}, train=train)
    assert calls == ([] if train else [4])
    _assert_rel(out.numpy(), ref, 1e-5)
    _assert_stats(tm, upd["batch_stats"], convert.GENERATOR_RENAMES)


@pytest.mark.parametrize("train", [False, True])
def test_any_spade_res_block(train, monkeypatch):
    """Spectral resblock with a learned shortcut over MultiSpade: eval
    (fused chain) and train (stats and u updated). rtol 1e-4."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    x, seg = _spade_inputs(10)
    jm = JResBlock(fin=32, fout=16, norm_G="spectralspadesyncbatch3x3", spade_ctor=JMultiSpade)
    variables = _with_random_stats(
        _np(jm.init(jax.random.PRNGKey(11), x, seg, train=True)), 12)
    ref, upd = jm.apply(variables, x, seg, train=train, update_stats=train,
                        mutable=["batch_stats"])
    tm = AnySpadeResBlock(32, 16, "spectralspadesyncbatch3x3",
                          make_spade=lambda c: MultiSpade(c, LABELS, "spadesyncbatch3x3"))
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    with torch.no_grad():
        out = tm(_t(x), {k: _t(v) for k, v in seg.items()}, train=train, update_stats=train)
    _assert_rel(out.numpy(), ref, 1e-4)
    _assert_stats(tm, upd["batch_stats"], convert.GENERATOR_RENAMES, tol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_sams_generator_tiny(train, monkeypatch):
    """SamsGenerator at widths 2^3..2^5, one middle block, 3-frame clips,
    flow warp output: eval (every SPADE site fused) and train. rtol 1e-4."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    rng = np.random.RandomState(13)
    B, H, W = 2, 32, 24
    prev = rng.randn(B, 2, H, W, 3).astype(np.float32)
    maps = rng.randn(B, 2, H, W, 2).astype(np.float32)
    cur = {k: rng.randn(B, H, W, c).astype(np.float32) for k, c in LABELS.items()}
    cfg = dict(ngf_pow_outer=3, ngf_pow_inner=5, num_middle=1, n_frames_total=3,
               flow_warp=True, encoder_input="flow", inputs=tuple(LABELS))
    jm = JSamsGenerator(**cfg)
    variables = _with_random_stats(
        _np(jm.init(jax.random.PRNGKey(14), prev, maps, cur, train=True)), 15)
    ref, upd = jm.apply(variables, prev, maps, cur, train=train, update_stats=train,
                        mutable=["batch_stats"])
    tm = SamsGenerator(**cfg)
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    with torch.no_grad():
        out = tm(_t(prev), _t(maps), {k: _t(v) for k, v in cur.items()},
                 train=train, update_stats=train)
    assert out.shape == (B, H, W, 4)
    _assert_rel(out.numpy(), ref, 1e-4)
    _assert_stats(tm, upd["batch_stats"], convert.GENERATOR_RENAMES, tol=1e-4)


def test_sams_generator_densepose_encoder(monkeypatch):
    """encoder_input="densepose" at 5 frames: the encoder SPADEs' label has
    3 x 4 = 12 channels (two 8-channel segments of the bf16 chain kernels,
    which refused it before), eval with every SPADE site fused, against the
    JAX generator: rtol 1e-4."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    rng = np.random.RandomState(19)
    B, H, W = 1, 16, 12
    prev = rng.randn(B, 4, H, W, 3).astype(np.float32)
    maps = rng.randn(B, 4, H, W, 3).astype(np.float32)
    cur = {k: rng.randn(B, H, W, c).astype(np.float32) for k, c in LABELS.items()}
    cfg = dict(ngf_pow_outer=3, ngf_pow_inner=5, num_middle=1, n_frames_total=5,
               flow_warp=True, encoder_input="densepose", inputs=tuple(LABELS))
    jm = JSamsGenerator(**cfg)
    variables = _with_random_stats(
        _np(jm.init(jax.random.PRNGKey(20), prev, maps, cur, train=True)), 21)
    ref = jm.apply(variables, prev, maps, cur, train=False)
    tm = SamsGenerator(**cfg)
    assert tm.enc_ch * tm.num_prev == 12
    convert.load_flax(tm, variables, convert.GENERATOR_RENAMES)
    with torch.no_grad():
        out = tm(_t(prev), _t(maps), {k: _t(v) for k, v in cur.items()}, train=False)
    assert out.shape == (B, H, W, 4)
    _assert_rel(out.numpy(), np.asarray(ref), 1e-4)


def test_gmm_128x96():
    """GMM at the smallest fine size its regression takes (128x96), eval
    with random running stats: grid and theta within rtol 1e-4."""
    rng = np.random.RandomState(16)
    person = rng.randn(2, 128, 96, 7).astype(np.float32)
    cloth = rng.randn(2, 128, 96, 3).astype(np.float32)
    jm = JGMM(fine_height=128, fine_width=96, grid_size=5, ngf=8)
    variables = _with_random_stats(
        _np(jm.init(jax.random.PRNGKey(17), person, cloth, train=False)), 18)
    grid_ref, theta_ref = jm.apply(variables, person, cloth, train=False)
    tm = GMM(7, 3, fine_height=128, fine_width=96, grid_size=5, ngf=8)
    convert.load_flax(tm, variables, convert.GMM_RENAMES)
    with torch.no_grad():
        grid, theta = tm(_t(person), _t(cloth), train=False)
    _assert_rel(theta.numpy(), theta_ref, 1e-4)
    _assert_rel(grid.numpy(), grid_ref, 1e-4)
