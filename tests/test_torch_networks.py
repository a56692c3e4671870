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
from shineon_tpu_torch.ops import fused_spade as tfs

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


# The SPADE sites' launch plans and segmap operands (spade.chain_plan,
# spade.SegmapMemo). On the card at eval fused_chain launches from them; the
# plan's parts are built from CPU tensors here, as they are there.

def _chain_case(L, C, dtype=torch.float32, int8=False, config="spadesyncbatch3x3", seed=0):
    """L SPADEs over LABELS' first L labels with seeded weights and running
    statistics (variances 0.5-1), x (2, 6, 5, C) and segmaps at twice its
    size."""
    g = torch.Generator().manual_seed(seed)
    labels = list(LABELS.values())[:L]
    spades = [SPADE(C, c, config_text=config, int8=int8) for c in labels]
    with torch.no_grad():
        for s in spades:
            for t in (*s.parameters(), *s.buffers()):
                t.copy_(torch.rand(t.shape, generator=g) * 0.5 + 0.5)
    x = torch.randn(2, 6, 5, C, generator=g).to(dtype)
    maps = [torch.randn(2, 12, 10, c, generator=g) for c in labels]
    return spades, x, maps


def _plan_counts():
    fc = tspade.fused_chain
    return fc.plan_builds, fc.plan_hits, fc.segmap_builds, fc.segmap_hits


def _diff(after, before):
    return tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,C", [(1, 64), (4, 32)])
def test_chain_plan_folds_as_fused_args(L, C, dtype, int8):
    """A site's plan: its ab equals fused_args' fold bit for bit (zero-padded
    to the kernel's 64-channel tile), its weights the chain's packed as the
    uncached path packs them, its shapes x's and the segmap operand's."""
    spades, x, maps = _chain_case(L, C, dtype, int8)
    with torch.no_grad():
        plan = tspade.chain_plan(spades, x)
        args = [s.fused_args(x, m) for s, m in zip(spades, maps)]
        packed = tfs.pack_weights([a[2] for a in args], [a[3] for a in args],
                                  [a[4] for a in args], [a[5] for a in args], dtype, int8)
    ab = torch.stack([a[0] for a in args], dim=1)
    want = torch.zeros(2, L, 2 * 64)
    want[..., :C], want[..., 64:64 + C] = ab[..., :C], ab[..., C:]
    assert plan.ab.dtype == torch.float32 and torch.equal(plan.ab, want)
    for mine, theirs in zip(plan.packed, packed):
        assert (mine == theirs) if not isinstance(mine, torch.Tensor) else torch.equal(mine, theirs)
    seg = tfs.kernel_segmap([a[1] for a in args], dtype)
    assert plan.shape == tuple(x.shape) and plan.seg_shape == tuple(seg.shape)
    assert (plan.dtype, plan.Cp, plan.act_name) == (dtype, 64, "relu")


@pytest.mark.parametrize("change", ["none", "train_forward", "weight_edit", "weight_replaced",
                                    "batch"])
def test_chain_plan_is_kept_until_its_state_changes(change):
    """A second call takes the kept plan; a train-mode forward (running
    statistics updated in place), an in-place weight edit, a replaced weight
    or another batch size makes it anew, equal to a plan made from
    scratch. plan_builds and plan_hits count each."""
    spades, x, maps = _chain_case(4, 64)
    before = _plan_counts()
    with torch.no_grad():
        first = tspade.chain_plan(spades, x)
        assert tspade.chain_plan(spades, x) is first
        assert _diff(_plan_counts(), before) == (1, 1, 0, 0)
        if change == "train_forward":
            spades[2](x, maps[2], train=True)
        elif change == "weight_edit":
            spades[3].mlp_beta.weight.mul_(2)
        elif change == "weight_replaced":
            spades[1].mlp_shared.weight = torch.nn.Parameter(spades[1].mlp_shared.weight * 2)
        elif change == "batch":
            x = x[:1]
        plan = tspade.chain_plan(spades, x)
        rebuilt = change != "none"
        assert (plan is not first) == rebuilt
        assert _diff(_plan_counts(), before) == (1 + rebuilt, 2 - rebuilt, 0, 0)
        spades[0]._plan = None
        spades[0]._packed = tspade.EvalCache()
        fresh = tspade.chain_plan(spades, x)
    assert torch.equal(plan.ab, fresh.ab) and plan.shape == fresh.shape
    for mine, theirs in zip(plan.packed[1:], fresh.packed[1:]):
        assert (mine is None and theirs is None) or torch.equal(mine, theirs)
    moved = {"train_forward": lambda p: p.ab, "weight_edit": lambda p: p.packed.wgb,
             "weight_replaced": lambda p: p.packed.wsh}.get(change)
    if moved is not None:
        assert not torch.equal(moved(first), moved(plan))


@pytest.mark.parametrize("L", [1, 4])
def test_chain_plan_never_kept_for_instance_norm(L):
    """An instance-norm chain's fold depends on x: no plan, nothing kept,
    nothing counted."""
    spades, x, _ = _chain_case(L, 64, config="spadeinstance3x3")
    before = _plan_counts()
    with torch.no_grad():
        assert tspade.chain_plan(spades, x) is None
    assert spades[0]._plan is None and _plan_counts() == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segmap_memo_matches_only_the_same_unmodified_tensors(dtype):
    """The memo's operand equals kernel_segmap of the resized labelmaps bit
    for bit; the same tensors at the same resolution hit; another
    resolution, new tensors of the same shape and values, and an in-place
    edit of a source each build; an entry whose labelmap is gone is dropped
    at the next build, and at most ``size`` entries are kept."""
    memo = tspade.SegmapMemo(size=3)
    _, _, maps = _chain_case(4, 64)
    before = _plan_counts()
    seg = memo.get(maps, 6, 5, dtype)
    want = tfs.kernel_segmap([tspade.resize_nearest(m, 6, 5).to(dtype) for m in maps], dtype)
    assert seg.dtype == dtype and torch.equal(seg, want)
    assert memo.get(maps, 6, 5, dtype) is seg
    assert memo.get(maps, 12, 10, dtype) is not seg
    copies = [m.clone() for m in maps]
    assert memo.get(copies, 6, 5, dtype) is not seg
    maps[1].add_(1.0)
    edited = memo.get(maps, 6, 5, dtype)
    assert edited is not seg and not torch.equal(edited, seg)
    assert memo.get(maps, 6, 5, dtype) is edited
    assert _diff(_plan_counts(), before) == (0, 0, 4, 2)
    assert len(memo._entries) == 3
    del copies
    memo.get(maps, 3, 3, dtype)
    assert len(memo._entries) == 3 and all(r() is not None
                                           for e in memo._entries.values() for r in e[0])
    memo.get(maps, 2, 2, dtype)
    assert len(memo._entries) == 3 and memo.get(maps, 12, 10, dtype) is not None
    assert _diff(_plan_counts(), before) == (0, 0, 7, 2)


@pytest.mark.parametrize("L", [1, 4])
def test_fused_chain_on_the_cpu_takes_no_plan(L):
    """On the CPU the chain takes its plain version, as before: no plan, no
    memo, nothing counted."""
    spades, x, maps = _chain_case(L, 64)
    before = _plan_counts()
    with torch.no_grad():
        out = tspade.fused_chain(spades, x, maps)
        args = [s.fused_args(x, m) for s, m in zip(spades, maps)]
        ab, segs, wshs, bshs, wgbs, bgbs = zip(*args)
        ref = tfs.multispade_modulate_plain(x, torch.stack(ab, dim=1), segs, wshs, bshs, wgbs,
                                            bgbs)
    assert torch.equal(out, ref)
    assert _plan_counts() == before and spades[0]._plan is None


@pytest.mark.parametrize("bad", ["x_shape", "x_dtype", "seg_shape", "seg_dtype", "seg_layout"])
def test_launch_plan_checks_x_and_the_segmap(bad):
    """A planned launch refuses x or a segmap operand that does not fit its
    plan, before it reaches the card."""
    spades, x, maps = _chain_case(4, 64, torch.bfloat16)
    with torch.no_grad():
        plan = tspade.chain_plan(spades, x)
    seg = tspade.SegmapMemo().get(maps, 6, 5, torch.bfloat16)
    if bad == "x_shape":
        x = x[:, :5]
    elif bad == "x_dtype":
        x = x.float()
    elif bad == "seg_shape":
        seg = seg[:, :5].contiguous()
    elif bad == "seg_dtype":
        seg = seg.float()
    else:
        seg = seg.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="x is" if bad.startswith("x") else "seg"):
        tfs.fused_multispade_modulate(x, plan.ab, maps, plan=plan, seg=seg)
