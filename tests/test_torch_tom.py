"""The port's TOM (the U-Net try-on model) against the JAX package on the
CPU, f32: the 2x bilinear upsample, the UnetGenerator at ngf 8 (the
default activations, relu, gelu and swish, with and without attention; sine
at its innermost level, the whole net being chaotic), the TOM options, and the TOM
model's losses, gradient, one Adam step, validation, visual and test
steps. TOM's width follows its frame count, so the model runs once, at
64x64 with two frames, flow_warp and three attention levels, every gamma
drawn nonzero. Weights are made in JAX and carried across with
shineon_tpu_torch.convert (convert.UNET_RENAMES, convert.VGG_RENAMES);
inputs come from a numpy seed.

The ``gpu``-marked tests at the end run a small TOM step on the card (they
skip here) and need no JAX: ``python3 -m pytest --noconftest
tests/test_torch_tom.py -m gpu -q``."""

import numpy as np
import pytest
import torch

from shineon_tpu_torch import convert
from shineon_tpu_torch.bench import build_train
from shineon_tpu_torch.models.unet_mask_model import UnetMaskModel, tom_ngf
from shineon_tpu_torch.networks.cpvton.unet import UnetGenerator, upsample_bilinear_2x
from shineon_tpu_torch.options import tom_options
from shineon_tpu_torch.serving import synthetic_raw_batch

try:  # every test but the gpu-marked ones; the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from shineon_tpu.models.unet_mask_model import UnetMaskModel as JUnetMaskModel
    from shineon_tpu.networks.cpvton.unet import UnetGenerator as JUnetGenerator
    from shineon_tpu.networks.cpvton.unet import upsample_bilinear_2x as j_upsample
    from shineon_tpu.options.base_options import namespace_from_defaults
    from test_torch_attention import with_nonzero_gamma
    from test_torch_networks import _np, _t, one_torch_thread  # noqa: F401
    from test_torch_training import adam_step_flips, state_dict_of
except ImportError:
    pass

# TOM's model test: 64x64, two frames, the flow warp, the documented three
# attention levels and swish, f32, batch 2
SMALL_TOM = dict(fine_height=64, fine_width=64, n_frames_total=2, flow_warp=True,
                 precision=32)
STEPS_PER_EPOCH = 4


def test_tom_options_match_jax_defaults():
    """tom_options is the JAX package's `--model unet_mask --self_attn
    --num_attn 3 --activation swish` configuration of docs/3_train.md; an
    unknown key raises. Its U-Net width is 64 at one frame, 167 at five."""
    ref = namespace_from_defaults("unet_mask", "viton", self_attn=True, num_attn=3,
                                  activation="swish")
    opt = tom_options()
    for key in ("person_inputs", "cloth_inputs", "fine_height", "fine_width", "batch_size",
                "self_attn", "num_attn", "activation", "pen_flow_mask", "precision", "lr",
                "keep_epochs", "decay_epochs", "accumulated_batches", "flow_warp"):
        value, want = getattr(opt, key), getattr(ref, key)
        if isinstance(want, (list, tuple)):
            value, want = list(value), list(want)
        assert value == want, key
    assert getattr(ref, "n_frames_total", 1) == opt.n_frames_total == 1
    assert (tom_ngf(1), tom_ngf(2), tom_ngf(5)) == (64, 108, 167)
    with pytest.raises(ValueError, match="unknown options"):
        tom_options(ngf=32)


@pytest.mark.parametrize("hw", [(1, 1), (3, 5), (4, 3), (7, 2)])
def test_upsample_bilinear_2x_matches_jax(hw):
    """F.interpolate(scale 2, bilinear, align_corners=False) against
    jax.image.resize(..., "linear"), the edge rows and columns included:
    within 1e-6 of the largest entry."""
    x = np.random.RandomState(hw[0] * 10 + hw[1]).randn(2, *hw, 3).astype(np.float32)
    ref = np.asarray(j_upsample(jnp.asarray(x)))
    out = upsample_bilinear_2x(_t(x)).numpy()
    assert out.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    for i, j in ((0, 0), (-1, -1)):  # the corners repeat the input's
        np.testing.assert_allclose(out[:, i, j], x[:, i, j], rtol=0, atol=1e-6)


def exactly_zero_gradient(name: str, depth: int) -> bool:
    """Whether a U-Net parameter's exact gradient is 0: a conv bias that
    feeds an instance norm (every upconv's; every downconv's but the
    outermost's and the innermost's, at ``depth`` submodules) and an
    attention key conv's bias (each query's scores all move by q.b, which
    the softmax ignores)."""
    if name.endswith(("upconv.bias", "key_conv.bias")):
        return True
    return name.endswith("downconv.bias") and 0 < name.count("submodule") < depth


def zero_gradient_entries(name: str, shape, depth: int, innermost_hw) -> np.ndarray:
    """The entries of a U-Net parameter whose exact gradient is 0: the
    whole tensor where exactly_zero_gradient says so; and, where the
    innermost level's map is 1x1 (64x64 frames), the centre tap of its
    upconv: the upsampled map is one value a channel, which the centre tap
    meets at every output pixel, and the instance norm after the conv
    removes a channel's constant."""
    zero = np.full(shape, exactly_zero_gradient(name, depth))
    if innermost_hw == (1, 1) and name == "model." + "submodule." * depth + "upconv.weight":
        zero[:, :, 1, 1] = True
    return zero


def assert_gradients_match(mine, ref):
    """Each tensor within 1e-3 of its largest entry; where the exact
    gradient is 0 (exactly_zero_gradient) both frameworks give f32 noise,
    and both are held under 1e-5 of the whole gradient's largest entry."""
    assert sorted(mine) == sorted(ref)
    largest = max(np.abs(r).max() for r in ref.values())
    depth = max(name.count("submodule") for name in ref)
    for name, r in ref.items():
        if exactly_zero_gradient(name, depth):
            assert max(np.abs(r).max(), np.abs(mine[name]).max()) <= 1e-5 * largest, name
        else:
            assert np.abs(mine[name] - r).max() <= 1e-3 * np.abs(r).max(), name


@pytest.mark.parametrize("attention", [False, True], ids=["plain", "attention"])
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "swish"])
def test_unet_generator_matches_jax(activation, attention):
    """UnetGenerator at ngf 8 (6 levels on 64x64, instance norm; with
    attention its three innermost levels, every gamma nonzero), the JAX
    tree loaded by convert.UNET_RENAMES: the output in train and in eval
    mode within 1e-4 of its largest entry, and the gradient of
    sum(out * r) for the input and every parameter (assert_gradients_match:
    within 1e-3 of each tensor's largest entry, f32 noise where the exact
    gradient is 0)."""
    kw = dict(input_nc=10, output_nc=4, num_downs=6, num_attention=3, ngf=8,
              norm="instance", use_self_attn=attention, activation=activation)
    jm = JUnetGenerator(**kw)
    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, (2, 64, 64, 10)).astype(np.float32)
    r = rng.randn(2, 64, 64, 4).astype(np.float32)
    variables = _np(jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 10)), train=False))
    if attention:
        variables = with_nonzero_gamma(variables, 9)
    tm = UnetGenerator(**kw)
    convert.load_flax(tm, variables, convert.UNET_RENAMES)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        np.size(v) for v in jax.tree_util.tree_leaves(variables))

    @jax.jit
    def run(v, a):
        out = jm.apply(v, a, train=True)
        grads = jax.grad(lambda v, a: jnp.sum(jm.apply(v, a, train=True) * r),
                         argnums=(0, 1))(v, a)
        return out, jm.apply(v, a, train=False), grads

    out_train, out_eval, (jgrads, jgx) = run(variables, x)
    xt = _t(x).requires_grad_()
    out = tm(xt)
    params = dict(tm.named_parameters())
    grads = torch.autograd.grad((out * _t(r)).sum(), [xt, *params.values()])
    for ref in (out_train, out_eval):
        ref = np.asarray(ref)
        assert np.abs(out.detach().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    ref = {"input": np.asarray(jgx),
           **state_dict_of(_np(jgrads), convert.UNET_RENAMES)}
    assert_gradients_match(dict(zip(["input", *params], (g.numpy() for g in grads))), ref)


@pytest.mark.parametrize("attention", [False, True], ids=["plain", "attention"])
def test_unet_block_with_sine_matches_jax(attention):
    """--activation sine, sin(30 x), at the innermost U-Net level (two
    sines; with attention at both its ends, gamma nonzero): the output in
    train and eval mode within 1e-4 of its largest entry and the gradients
    as in test_unet_generator_matches_jax. The whole U-Net runs twelve
    sines, each multiplying a rounding difference by up to 30: at these
    random weights the JAX package's own ngf-8 U-Net output moves by 1.01
    of its largest entry under a 1e-6 relative change of its first conv's
    kernel, so no two f32 implementations can agree there."""
    from shineon_tpu.networks.cpvton.unet import UnetSkipConnectionBlock as JBlock
    from shineon_tpu_torch.networks.cpvton.unet import UnetSkipConnectionBlock

    kw = dict(innermost=True, norm="instance", self_attn=attention, activation="sine")
    jb = JBlock(64, 64, **kw)
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (2, 8, 8, 64)).astype(np.float32)
    r = rng.randn(2, 8, 8, 128).astype(np.float32)
    variables = _np(jb.init(jax.random.PRNGKey(2), jnp.zeros((1, 8, 8, 64)), train=False))
    if attention:
        variables = with_nonzero_gamma(variables, 3)
    tb = UnetSkipConnectionBlock(64, 64, **kw)
    convert.load_flax(tb, variables, convert.UNET_RENAMES)

    @jax.jit
    def run(v, a):
        grads = jax.grad(lambda v, a: jnp.sum(jb.apply(v, a, train=True) * r),
                         argnums=(0, 1))(v, a)
        return jb.apply(v, a, train=True), jb.apply(v, a, train=False), grads

    out_train, out_eval, (jgrads, jgx) = run(variables, x)
    xt = _t(x).requires_grad_()
    out = tb(xt)
    params = dict(tb.named_parameters())
    grads = torch.autograd.grad((out * _t(r)).sum(), [xt, *params.values()])
    for ref in (out_train, out_eval):
        ref = np.asarray(ref)
        assert np.abs(out.detach().numpy() - ref).max() <= 1e-4 * np.abs(ref).max()
    ref = {"input": np.asarray(jgx), **state_dict_of(_np(jgrads), convert.UNET_RENAMES)}
    assert_gradients_match(dict(zip(["input", *params], (g.numpy() for g in grads))), ref)


# ------------------------------------------------------------------- TOM

class JaxTom:
    """A JAX UnetMaskModel at SMALL_TOM with every gamma nonzero, its
    initial state in numpy, its VGG filters, and the raw batch."""

    def __init__(self):
        self.opt = tom_options(batch_size=2, **SMALL_TOM)
        self.model = JUnetMaskModel(self.opt)
        state = self.model.init_state(jax.random.PRNGKey(13), STEPS_PER_EPOCH)
        params = with_nonzero_gamma(_np(state.nets["unet"].params), 14)
        self.variables = {"params": params}
        net = state.nets["unet"]
        self.state = state.replace(nets={"unet": net.replace(
            params=jax.tree_util.tree_map(jnp.asarray, params))})
        self.raw = {k: v.numpy() for k, v in synthetic_raw_batch(self.opt, 2, seed=6).items()}
        self.batch = {k: jnp.asarray(v) for k, v in self.raw.items()}

    def port(self):
        model = UnetMaskModel(self.opt, device="cpu")
        convert.load_flax(model.unet, self.variables, convert.UNET_RENAMES)
        convert.load_flax(model.criterion_vgg.model, _np(self.model.criterion_vgg.variables),
                          convert.VGG_RENAMES)
        state = model.make_state(STEPS_PER_EPOCH)
        return model, state, {k: torch.from_numpy(v) for k, v in self.raw.items()}


@pytest.fixture(scope="module")
def tom():
    return JaxTom()


def _assert_metrics(out, ref, tol):
    assert sorted(out) == sorted(ref)
    for k, r in ref.items():
        assert abs(float(out[k]) - float(r)) <= tol * max(abs(float(r)), 1e-6), k


def test_tom_losses_gradient_and_step_match_jax(tom):
    """TOM's loss terms (the composite through the flow warp, L1 and VGG of
    the last two frames, the masks' L1, the flow-mask sum) within 1e-4;
    the gradient of every U-Net parameter (assert_gradients_match: within
    1e-3 of the tensor's largest entry, f32 noise where the exact gradient
    is 0; through the attention kernel's plain version and its recompute
    backward at the three innermost levels, and live through resample2d);
    then one training step: its metrics within 1e-4 and the
    Adam step (optax on the JAX gradient) within 1e-3 lr of every entry,
    apart from sign flips at a gradient within f32 noise of 0, which are
    counted (at most 0.1%), and the entries whose exact gradient is 0
    (zero_gradient_entries: 11% of one tensor at this size), which move by
    at most lr either way."""
    jm, params = tom.model, tom.state.nets["unet"].params

    @jax.jit
    def grad_of(p, batch):
        feats = jm.features(batch)
        return jax.value_and_grad(lambda q: jm._losses(q, feats, train=True), has_aux=True)(p)

    (_, (jmetrics, _)), jgrads = grad_of(params, tom.batch)
    model, state, raw = tom.port()
    named = dict(model.unet.named_parameters())
    loss, metrics, _ = model.losses(model.features(raw))
    grads = torch.autograd.grad(loss, list(named.values()))
    _assert_metrics({k: v.detach() for k, v in metrics.items()}, jmetrics, 1e-4)
    assert "loss/G/l1_prev" in metrics and float(metrics["loss/G/flow_mask_l1"].detach()) > 1.0
    assert_gradients_match(dict(zip(named, (g.numpy() for g in grads))),
                           state_dict_of({"params": _np(jgrads)}, convert.UNET_RENAMES))

    updates, _ = jm._tx.update(jgrads, tom.state.nets["unet"].opt_state, params)
    jnew = state_dict_of({"params": _np(jax.tree_util.tree_map(
        lambda p, u: p + u, params, updates))}, convert.UNET_RENAMES)
    model, state, raw = tom.port()
    before = {k: v.clone().numpy() for k, v in model.unet.state_dict().items()}
    metrics = model.make_train_step()(state, raw)
    assert state.step == 1 and metrics.pop("lr") == tom.opt.lr
    _assert_metrics(metrics, jmetrics, 1e-4)
    jg = state_dict_of({"params": _np(jgrads)}, convert.UNET_RENAMES)
    largest = max(np.abs(g).max() for g in jg.values())
    depth = max(name.count("submodule") for name in jg)
    innermost = (SMALL_TOM["fine_height"] >> depth + 1, SMALL_TOM["fine_width"] >> depth + 1)
    flipped = total = 0
    for key, r in jnew.items():
        out, zero = model.unet.state_dict()[key].numpy(), zero_gradient_entries(
            key, r.shape, depth, innermost)
        # where the exact gradient is 0 Adam moves by +-lr either way
        assert np.abs(jg[key][zero]).max(initial=0) <= 1e-5 * largest, key
        adam_step_flips(before[key][zero], out[zero], r[zero], tom.opt.lr, key)
        flipped += adam_step_flips(before[key][~zero], out[~zero], r[~zero], tom.opt.lr, key)
        total += r.size - zero.sum()
    assert flipped <= 1e-3 * total, (flipped, total)


def test_tom_val_visual_and_test_steps_match_jax(tom):
    """The validation metrics with checkpoint_on (the loss) within 1e-4,
    every tensor of the visual step within 1e-4 of its largest entry, and
    the test forward's last composite, which is the visual step's p_tryon."""
    jval = tom.model.make_val_step()(tom.state, tom.batch)
    jvis = tom.model.make_visual_step()(tom.state, tom.batch)
    model, state, raw = tom.port()
    _assert_metrics(model.make_val_step()(state, raw), jval, 1e-4)
    vis = model.make_visual_step()(state, raw)
    assert sorted(vis) == sorted(jvis)
    for k, r in jvis.items():
        r = np.asarray(r)
        assert vis[k].shape == r.shape, k
        assert np.abs(vis[k].numpy() - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-6), k
    torch.testing.assert_close(model.test_fn(state, raw), vis["p_tryon"], rtol=0, atol=0)


# --------------------------------------------------------------- the card

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
def test_small_tom_step_on_card_matches_cpu():
    """One f32 TOM step (64x64, two frames, flow warp, three attention
    levels, every gamma nonzero) from the same seeded state on the card and
    on the CPU: every metric within rel 1e-3; on the card the attention
    kernel runs once a block (6 launches)."""
    _cuda_or_skip()
    from shineon_tpu_torch.networks.attention import SelfAttention
    from shineon_tpu_torch.ops.fused_attention import sagan_attention

    results = []
    for device in ("cuda", "cpu"):
        model, state, step, raw, _ = build_train(2, device=device, seed=3, model="unet_mask",
                                                 **SMALL_TOM)
        g = torch.Generator().manual_seed(4)
        with torch.no_grad():
            for m in model.unet.modules():
                if isinstance(m, SelfAttention):
                    m.gamma.copy_(0.5 + 0.1 * torch.randn(1, generator=g))
        before = sagan_attention.launches
        metrics = {k: float(v) for k, v in step(state, raw).items()}
        results.append((metrics, sagan_attention.launches - before))
    (mc, launched), (mh, _) = results
    assert launched == 6
    for k in mh:
        assert mc[k] == pytest.approx(mh[k], rel=1e-3), k


@pytest.mark.gpu
def test_upsample_gradient_on_card_matches_cpu():
    """upsample_bilinear_2x forward and gradient on the card against the
    CPU (within 1e-5 of the largest entry; the CUDA backward sums with
    atomics), on an NHWC tensor whose NCHW view has channels-last strides,
    the layout on which PyTorch's CUDA avg_pool2d backward was found wrong
    (U-Net shapes: 4 x 64 x 48 x 128)."""
    _cuda_or_skip()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, 48, 128, generator=g)
    w = torch.randn(4, 128, 96, 128, generator=g)
    results = []
    for device in ("cuda", "cpu"):
        xd = x.to(device).requires_grad_()
        y = upsample_bilinear_2x(xd)
        (gx,) = torch.autograd.grad((y * w.to(device)).sum(), [xd])
        results.append((y.detach().cpu(), gx.cpu()))
    (yc, gc), (yh, gh) = results
    assert (yc - yh).abs().max() <= 1e-5 * yh.abs().max()
    assert (gc - gh).abs().max() <= 1e-5 * gh.abs().max()
