"""The port's training modules against the JAX package on the CPU, f32:
the GAN loss, the init rules, the keep/decay schedule and Adam, the
training options, the VGG missing-weights gate, and the helpers that hold
a whole step against the JAX step (JaxSide, assert_step_matches). Weights
are made in JAX and carried across with shineon_tpu_torch.convert; inputs
come from a numpy seed. Apart, so that each file's JAX compiles run on a
worker of their own: the generator's gradient and the exact and fast
steps without attention (test_torch_training_step.py), the step with
attention blocks (test_torch_training_attention.py), remat against no
remat (test_torch_training_remat.py), and the discriminators, VGG19 and
the perceptual loss (test_torch_training_networks.py).

The ``gpu``-marked tests at the end run a small step on the card (they skip
here). They need no JAX: ``python3 -m pytest --noconftest
tests/test_torch_training.py -m gpu -q`` runs them where only PyTorch is
installed."""

import numpy as np
import pytest
import torch

from shineon_tpu_torch import convert
from shineon_tpu_torch.bench import build_train
from shineon_tpu_torch.datasets.n_frames_interface import fold_frames_into_channels
from shineon_tpu_torch.models.sams_model import SamsModel, split_predictions
from shineon_tpu_torch.networks.init import kernel_init_
from shineon_tpu_torch.networks.loss import GANLoss
from shineon_tpu_torch.networks.vgg import MissingVgg19WeightsError, load_vgg19
from shineon_tpu_torch.options import sams_options
from shineon_tpu_torch.training.optimizers import (
    Adam,
    MultiSteps,
    keep_decay_schedule,
    make_optimizer,
)

try:  # every test but the gpu-marked ones; the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    import optax

    from __graft_entry__ import _raw_batch, _sams_opt
    from shineon_tpu.models.sams_model import SamsModel as JSamsModel
    from shineon_tpu.networks.init import kernel_init_for
    from shineon_tpu.networks.loss import GANLoss as JGANLoss
    from shineon_tpu.training.optimizers import keep_decay_schedule as j_keep_decay_schedule
    from test_torch_attention import with_nonzero_gamma
    from test_torch_networks import _assert_rel, _np, _t, one_torch_thread  # noqa: F401
except ImportError:
    pass

# the JAX package's own tiny training configuration (tests/test_train_e2e.py:167-185):
# 32x24, 3-frame clips, widths 2^3..2^5, one middle block, ndf 8, f32
TINY_TRAIN = dict(fine_height=32, fine_width=24, n_frames_total=3, n_frames_now=3,
                  ngf_pow_outer=3, ngf_pow_inner=5, num_middle=1, ndf=8, precision=32)


def _flat(tree):
    """Every leaf of a nested list as a numpy array."""
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in _flat(t)]
    return [np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree)]


def test_split_predictions_and_fold_match_jax():
    """split_predictions keeps the nested structure and halves each batch;
    fold_frames_into_channels is the JAX package's frame-major fold."""
    from shineon_tpu.datasets.n_frames_interface import fold_frames_into_channels as jfold
    from shineon_tpu.models.sams_model import _split_predictions as jsplit

    x = np.arange(2 * 3 * 4 * 5 * 2, dtype=np.float32).reshape(2, 3, 4, 5, 2)
    np.testing.assert_array_equal(fold_frames_into_channels(_t(x)).numpy(), np.asarray(jfold(x)))
    pred = [[np.arange(8.0).reshape(4, 2), np.ones((4, 1))], np.arange(4.0)]
    fake, real = split_predictions([[_t(p) for p in pred[0]], _t(pred[1])])
    jfake, jreal = jsplit(pred)
    for o, r in zip(_flat([fake, real]), _flat([jfake, jreal])):
        np.testing.assert_array_equal(o, r)


# ---------------------------------------------------------------- VGG19

def test_vgg_missing_weights_gate(monkeypatch):
    """Without SHINEON_VGG19_WEIGHTS load_vgg19 raises, unless random
    filters are asked for by argument or by SHINEON_ALLOW_RANDOM_VGG=1; the
    random filters are a function of the seed."""
    monkeypatch.delenv("SHINEON_VGG19_WEIGHTS", raising=False)
    monkeypatch.delenv("SHINEON_ALLOW_RANDOM_VGG", raising=False)
    with pytest.raises(MissingVgg19WeightsError, match="SHINEON_VGG19_WEIGHTS"):
        load_vgg19()
    monkeypatch.setenv("SHINEON_ALLOW_RANDOM_VGG", "0")
    with pytest.raises(MissingVgg19WeightsError):
        load_vgg19()
    with pytest.raises(MissingVgg19WeightsError):  # the training options can require them
        build_train(1, device="cpu", allow_random_vgg=False, **TINY_TRAIN)
    a, b = load_vgg19(allow_random=True), load_vgg19(allow_random=True)
    monkeypatch.setenv("SHINEON_ALLOW_RANDOM_VGG", "1")
    c, d = load_vgg19(), load_vgg19(seed=1)
    for p, q, r, s in zip(a.parameters(), b.parameters(), c.parameters(), d.parameters()):
        assert torch.equal(p, q) and torch.equal(p, r)
        assert p.dim() == 1 or not torch.equal(p, s)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("mode", ["hinge", "ls", "original", "w"])
def test_gan_loss_matches_jax(mode):
    """Both directions (the discriminator's toward real and toward fake,
    the generator's toward real) on a multiscale nested list, a plain list
    and a tensor, and in bf16 input as the bf16 discriminators give it: the
    loss and its gradient (rel 1e-5: f32 means summed in another order)."""
    rng = np.random.RandomState(3)
    feats = [[rng.randn(2, 3, 3, 4), rng.randn(2, 5, 4, 1)], [rng.randn(2, 4, 3, 1)]]
    feats = [[f.astype(np.float32) for f in scale] for scale in feats]
    jloss, tloss = JGANLoss(mode), GANLoss(mode)
    cases = [(True, True), (False, True), (True, False)]
    for target_is_real, for_d in cases:
        for pick in (lambda p: p, lambda p: [s[-1] for s in p], lambda p: p[0][-1]):
            jp = pick(jax.tree_util.tree_map(jnp.asarray, feats))
            ref, jg = jax.value_and_grad(lambda p: jloss(p, target_is_real, for_d))(jp)
            tp = pick([[_t(f).requires_grad_() for f in s] for s in feats])
            out = tloss(tp, target_is_real, for_d)
            leaves = _flat_tensors(tp)
            grads = torch.autograd.grad(out, leaves, allow_unused=True)
            _assert_rel(out.detach().numpy(), ref, 1e-5)
            for g, leaf, r in zip(grads, leaves, _flat(jg)):  # features: zero gradient
                g = torch.zeros_like(leaf) if g is None else g
                if np.abs(r).max() == 0:
                    assert not g.any()
                else:
                    _assert_rel(g.numpy(), r, 1e-5)
    bf = [[_t(f).bfloat16() for f in s] for s in feats]
    jbf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), feats)
    _assert_rel(tloss(bf, True, True).numpy(), jloss(jbf, True, True), 1e-5)


def _flat_tensors(tree):
    if isinstance(tree, (list, tuple)):
        return [a for t in tree for a in _flat_tensors(t)]
    return [tree]


# ---------------------------------------------------- init, options, Adam

@pytest.mark.parametrize("init_type", ["normal", "xavier", "xavier_uniform", "kaiming", "none"])
def test_kernel_init_matches_jax_distribution(init_type):
    """kernel_init_ draws from the JAX package's kernel_init_for
    distribution on the same (HWIO) fans: the standard deviations of 2^16
    draws agree within 2% and the means are within 0.02 std of 0."""
    shape = (4, 4, 64, 64)  # HWIO; the port's OIHW is (64, 64, 4, 4)
    ref = np.asarray(kernel_init_for(init_type, 0.02)(jax.random.PRNGKey(0), shape))
    w = torch.empty(64, 64, 4, 4)
    kernel_init_(w, init_type, 0.02, torch.Generator().manual_seed(0))
    assert abs(w.std().item() / ref.std() - 1) < 0.02
    assert abs(w.mean().item()) < 0.02 * ref.std()
    if init_type == "xavier_uniform":
        assert w.abs().max().item() <= np.abs(ref).max() * 1.001


def test_training_options_match_graft_entry():
    """Every training key of the port's options has the value of the JAX
    package's ``_sams_opt``; unknown keys still raise."""
    ref = vars(_sams_opt())
    opt = vars(sams_options())
    keys = ("init_type", "init_variance", "num_D", "ndf", "n_layers_D", "norm_D", "gan_mode",
            "lr", "lr_D", "no_ganFeat_loss", "wt_l1", "wt_vgg", "wt_multiscale", "wt_temporal",
            "keep_epochs", "decay_epochs", "accumulated_batches", "allow_random_vgg")
    for key in keys:
        assert opt[key] == ref[key], key
    for key in ("remat", "fast_gan_step", "reference_gan_semantics"):  # getattr(opt, k, False)
        assert opt[key] is False and key not in ref
    with pytest.raises(ValueError, match="unknown options"):
        sams_options(lr_G=1e-3)


def test_keep_decay_schedule_and_adam_match_optax():
    """The schedule equals the JAX package's at every step through the
    decay; Adam equals optax.adam on that schedule over 7 steps of seeded
    gradients spanning six decades, to one f32 rounding of the parameter
    (rel 2.4e-7) plus 1e-6 of the learning rate."""
    args = (1e-3, 1, 2, 2)  # keep 1 epoch, decay over 2, 2 steps an epoch
    sched, jsched = keep_decay_schedule(*args), j_keep_decay_schedule(*args)
    for step in range(10):
        assert abs(sched(step) - float(jsched(jnp.int32(step)))) <= 1e-9
    rng = np.random.RandomState(5)
    p0 = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    tx = optax.adam(jsched)
    jp = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jp)
    tp = [_t(p) for p in p0]
    adam = Adam(tp, sched)
    for _ in range(7):
        g = [rng.randn(*p.shape).astype(np.float32) * 10.0 ** rng.randint(-4, 2) for p in p0]
        updates, jstate = tx.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        adam.step([_t(a) for a in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2.4e-7, atol=1e-6 * 1e-3)
    assert adam.count == 7


def test_accumulated_batches_raises():
    """--accumulated_batches 2 wraps Adam in MultiSteps (optax.MultiSteps,
    tests/test_torch_cli.py holds its semantics); a saved optimizer state
    of the other kind raises on load, as the JAX package's restore of a
    state written at another accumulation does not fit its tree."""
    acc = make_optimizer([torch.zeros(1)], 1e-4, accumulate=2)
    plain = make_optimizer([torch.zeros(1)], 1e-4)
    assert isinstance(acc, MultiSteps) and isinstance(plain, Adam)
    with pytest.raises(ValueError, match="accumulat"):
        acc.load_state_dict(plain.state_dict())
    with pytest.raises(ValueError, match="accumulat"):
        plain.load_state_dict(acc.state_dict())


# ------------------------------------------------------------------- remat

def _snapshot(model):
    return {name: {k: v.clone() for k, v in net.state_dict().items()}
            for name, net in (("generator", model.generator),
                              ("d_multi", model.multiscale_discriminator),
                              ("d_temporal", model.temporal_discriminator))}



# --------------------------------------------- the whole step against JAX

BATCH = 2
STEPS_PER_EPOCH = 10
NETS = {"generator": ("generator", convert.GENERATOR_RENAMES),
        "d_multi": ("multiscale_discriminator", convert.DISCRIMINATOR_RENAMES),
        "d_temporal": ("temporal_discriminator", convert.DISCRIMINATOR_RENAMES)}
# attention in the last middle block (8x6, 48 tokens) and decoder block 0
# (16x12, 192 tokens), as test_torch_serving's TINY_ATTENTION
TINY_ATTENTION = dict(attention_middle_indices=("-1",), attention_decoder_indices=("0",))
STATS = ("running_mean", "running_var", ".u", ".sigma")


class JaxSide:
    """A JAX SamsModel at TINY_TRAIN (with attention: TINY_ATTENTION, every
    gamma drawn nonzero; ``overrides`` replace options on both sides), its
    initial state, that state copied to numpy before any step (the step may
    donate its buffers), and the raw batch."""

    def __init__(self, attention: bool, **overrides):
        self.placement = {**(TINY_ATTENTION if attention else {}), **overrides}
        self.opt = _sams_opt(batch_size=BATCH, **TINY_TRAIN, **self.placement)
        self.model = JSamsModel(self.opt)
        state = self.model.init_state(jax.random.PRNGKey(420), STEPS_PER_EPOCH)
        self.nets = {}
        for name, net in state.nets.items():
            params = _np(net.params)
            if attention and name == "generator":
                params = with_nonzero_gamma(params, 421)
            self.nets[name] = {"params": params, **_np(net.stats)}
        self.state = state.replace(nets={
            name: net.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            self.nets[name]["params"]))
            for name, net in state.nets.items()})
        self.raw = _raw_batch(self.opt, batch=BATCH)
        self.batch = {k: jnp.asarray(v) for k, v in self.raw.items()}

    def step(self, fast: bool = False):
        """The JAX step from the initial state: (new_state, metrics)."""
        self.model.opt.fast_gan_step = fast
        try:
            return self.model.make_train_step()(self.state, self.batch)
        finally:
            self.model.opt.fast_gan_step = False

    def port(self, **overrides):
        """The port's model with the same weights, statistics and VGG
        filters, its fresh state, and the raw batch as tensors."""
        opt = sams_options(batch_size=BATCH, is_train=True, **TINY_TRAIN, **self.placement,
                           **overrides)
        model = SamsModel(opt, device="cpu")
        for name, (attr, renames) in NETS.items():
            convert.load_flax(getattr(model, attr), self.nets[name], renames)
        convert.load_flax(model.criterion_vgg.model, _np(self.model.criterion_vgg.variables),
                          convert.VGG_RENAMES)
        state = model.make_state(STEPS_PER_EPOCH)
        return model, state, {k: torch.from_numpy(v) for k, v in self.raw.items()}


def assert_metrics(out, ref, tol_g, tol_d):
    """Every metric of the JAX step: the generator's within tol_g, the
    discriminators' within tol_d, of max(|ref|, 1)."""
    assert sorted(out) == sorted(ref)
    for k, r in ref.items():
        r, tol = float(r), (tol_d if k.startswith("loss/D/") else tol_g)
        assert abs(float(out[k]) - r) <= tol * max(abs(r), 1.0), (k, float(out[k]), r)


def state_dict_of(tree, renames):
    return {k: v.numpy() for k, v in convert.flax_to_state_dict(tree, renames).items()}


def adam_step_flips(p0, out, ref, lr, name):
    """Adam's first step moves a parameter by lr * g / (|g| + 1e-8), about
    lr * sign(g). The port's move and the JAX move agree within 1e-3 lr plus
    one f32 rounding of the parameter, except where the two gradients have
    opposite signs: entries whose gradient lies within the two frameworks'
    f32 difference of zero (biases feeding a batch norm, whose exact
    gradient is 0, and single entries of other tensors). There each moves
    by at most lr, either way. Returns how many entries flipped."""
    d_out, d_ref = out - p0, ref - p0
    bound = lr + 2.4e-7 * np.abs(p0)
    assert (np.abs(d_out) <= bound).all() and (np.abs(d_ref) <= bound).all(), name
    return int((np.abs(d_out - d_ref) > 1e-3 * lr + 2.4e-7 * np.abs(p0)).sum())


def assert_step_matches(side, new_state, jmetrics, model, metrics, exact):
    """The port's step against the JAX step from the same state.

    Metrics: the generator's within 1e-4. Statistics: the discriminators'
    spectral u and sigma within 1e-4 of each tensor's max. Parameters:
    :func:`adam_step_flips`, with at most 0.1% of the generator's entries
    flipped. The discriminators' updates and losses and the generator's
    statistics: with ``fast_gan_step`` they read the generator step's clip
    and are held like the rest (1e-4, 0.1%); in the exact step they read
    the clip regenerated by the updated generator, which the generator's
    flipped entries move: 1e-3 for the losses and the statistics, at most
    3% of a discriminator's entries flipped (0.3-1.4% seen here; a wrong
    gradient flips half). The exact and fast steps' discriminator losses
    differ by about 1e-2, ten times the limit."""
    loose = 1e-3 if exact else 1e-4
    assert_metrics(metrics, jmetrics, 1e-4, loose)
    for name, (attr, renames) in NETS.items():
        net = new_state.nets[name]
        lr = model.opt.lr if name == "generator" else model.opt.lr_D
        ref = state_dict_of({"params": _np(net.params), **_np(net.stats)}, renames)
        before = state_dict_of(side.nets[name], renames)
        mine = {k: v.detach().numpy() for k, v in getattr(model, attr).state_dict().items()}
        assert sorted(mine) == sorted(ref)
        flipped = total = 0
        for key, r in ref.items():
            if key.endswith(STATS):
                tol = loose if name == "generator" else 1e-4
                err = np.abs(mine[key] - r).max() / max(np.abs(r).max(), 1e-12)
                assert err <= tol, (name, key, err)
            else:
                flipped += adam_step_flips(before[key], mine[key], r, lr, key)
                total += r.size
        limit = 3e-2 if exact and name != "generator" else 1e-3
        assert flipped <= limit * total, (name, flipped, total)


# ------------------------------------------------------------ entry points

def test_build_train_default_device_raises_without_cuda():
    """The training entry point runs on the card unless told otherwise: on
    a host without CUDA it raises instead of training on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_train(1, **TINY_TRAIN)


# --------------------------------------------------------------- the card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
def test_small_step_on_card_matches_cpu():
    """One f32 exact step from the same seeded state on the card and on the
    CPU: every metric within rel 1e-3, every statistic within rel 1e-3 of
    its tensor's max."""
    _cuda_or_skip()
    results = []
    for device in ("cuda", "cpu"):
        model, state, step, raw, _ = build_train(2, device=device, seed=3, **TINY_TRAIN)
        metrics = step(state, raw)
        results.append(({k: float(v) for k, v in metrics.items()},
                         {n: {k: v.cpu() for k, v in sd.items()}
                          for n, sd in _snapshot(model).items()}))
    (mc, sc), (mh, sh) = results
    for k in mh:
        assert mc[k] == pytest.approx(mh[k], rel=1e-3), k
    for net in sh:
        for name, ref in sh[net].items():
            if name.endswith(("running_mean", "running_var", ".u", ".sigma")):
                err = (sc[net][name] - ref).abs().max() / ref.abs().max().clamp_min(1e-12)
                assert err.item() <= 1e-3, (net, name)


@pytest.mark.gpu
def test_avg_pool_gradient_on_card_matches_cpu():
    """The multiscale discriminator's no-pad-count average pool, forward and
    gradient, on the card against the CPU (rel 1e-6). PyTorch's CUDA
    avg_pool2d backward is wrong on channels-last strides, which an NHWC
    tensor's NCHW view has; avg_pool_no_pad_count pools a contiguous copy."""
    _cuda_or_skip()
    from shineon_tpu_torch.networks.discriminator import avg_pool_no_pad_count

    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, 48, 15, generator=g)
    w = torch.randn(4, 32, 24, 15, generator=g)
    results = []
    for device in ("cuda", "cpu"):
        xd = x.to(device).requires_grad_()
        y = avg_pool_no_pad_count(xd)
        (gx,) = torch.autograd.grad((y * w.to(device)).sum(), [xd])
        results.append((y.detach().cpu(), gx.cpu()))
    (yc, gc), (yh, gh) = results
    assert (yc - yh).abs().max() <= 1e-6 * yh.abs().max()
    assert (gc - gh).abs().max() <= 1e-6 * gh.abs().max()


@pytest.mark.gpu
def test_attention_step_launches_kernel_per_frame_pass():
    """An exact step with attention and remat launches the attention kernel
    once a block a frame in each of the three passes over the clip: the
    generator step, its backward recompute and the regeneration."""
    _cuda_or_skip()
    from shineon_tpu_torch.networks.attention import SelfAttention
    from shineon_tpu_torch.ops.fused_attention import sagan_attention

    placement = dict(attention_middle_indices=("-1",), attention_decoder_indices=("0",))
    model, state, step, raw, n_frames = build_train(
        2, **{**TINY_TRAIN, "precision": 16}, **placement)
    blocks = sum(isinstance(m, SelfAttention) for m in model.generator.modules())
    before = sagan_attention.launches
    metrics = step(state, raw)
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert sagan_attention.launches - before == 3 * n_frames * blocks
