"""The port's discriminators and VGG19 against the JAX package on the CPU,
f32 (moved out of test_torch_training.py so that its JAX compiles run on
a worker of their own): every feature, the stored spectral u and sigma
and the input gradient of the multiscale and n-layer discriminators, the
strided spectral conv, the VGG19 slices (converted, and read back from the
JAX package's .npz) and the perceptual loss with its gradient. Weights
are made in JAX and carried across with shineon_tpu_torch.convert; inputs
come from a numpy seed."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shineon_tpu.networks.discriminator import (
    MultiscaleDiscriminator as JMultiscaleDiscriminator,
)
from shineon_tpu.networks.discriminator import NLayerDiscriminator as JNLayerDiscriminator
from shineon_tpu.networks.loss import VGGLoss as JVGGLoss
from shineon_tpu.networks.vgg import Vgg19Features as JVgg19Features
from shineon_tpu.networks.vgg import save_vgg19_params
from shineon_tpu_torch import convert
from shineon_tpu_torch.networks.discriminator import (
    MultiscaleDiscriminator,
    NLayerDiscriminator,
)
from shineon_tpu_torch.networks.loss import VGGLoss
from shineon_tpu_torch.networks.normalization import SpectralConv2d
from shineon_tpu_torch.networks.vgg import Vgg19Features, load_vgg19
from test_torch_networks import _assert_rel, _np, _t, one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import _flat


# ------------------------------------------------------------ discriminators

@pytest.mark.parametrize("update_stats", [False, True])
@pytest.mark.parametrize("multiscale", [False, True], ids=["nlayer", "multiscale"])
def test_discriminator_matches_jax(multiscale, update_stats):
    """Every feature of every scale (max rel 1e-5 of the layer's max), and
    with ``update_stats`` the stored spectral u and sigma (rel 1e-5), from
    the flax tree carried across by convert.DISCRIMINATOR_RENAMES: k4 s2
    pad-2 spectral convs (SpectralConv2d's stride), instance norm, leaky
    ReLU, the no-pad-count average-pool pyramid, xavier(0.02) weights."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 32, 24, 7).astype(np.float32)
    kw = dict(ndf=8, n_layers=4, norm_D="spectralinstance")
    jd = JMultiscaleDiscriminator(num_D=2, **kw) if multiscale else JNLayerDiscriminator(**kw)
    variables = _np(jd.init(jax.random.PRNGKey(3), jnp.zeros((1, 32, 24, 7))))
    td = (MultiscaleDiscriminator(7, num_D=2, **kw) if multiscale
          else NLayerDiscriminator(7, **kw))
    convert.load_flax(td, variables, convert.DISCRIMINATOR_RENAMES)
    if update_stats:
        ref, new_vars = jd.apply(variables, x, update_stats=True, mutable=["batch_stats"])
    else:
        ref, new_vars = jd.apply(variables, x), None
    with torch.no_grad():
        out = td(_t(x), update_stats=update_stats)
    refs, outs = _flat(ref), _flat(out)
    assert len(outs) == len(refs) == (10 if multiscale else 5)
    for o, r in zip(outs, refs):
        _assert_rel(o, r, 1e-5)
    if update_stats:
        mine = td.state_dict()
        for name, value in convert.flax_to_state_dict(
                _np(new_vars), convert.DISCRIMINATOR_RENAMES).items():
            _assert_rel(mine[name].numpy(), value.numpy(), 1e-5)
            assert name.endswith((".u", ".sigma"))
    else:  # the gradient of the logits' sum with respect to the input, rel 1e-5
        jg = jax.grad(lambda a: sum(r.sum() for r in _flat_logits(jd.apply(variables, a))))(x)
        xt = _t(x).requires_grad_()
        (g,) = torch.autograd.grad(sum(r.sum() for r in _flat_logits(td(xt))), [xt])
        _assert_rel(g.numpy(), jg, 1e-5)


def _flat_logits(out):
    """The logits of a discriminator's output: the last feature of each scale."""
    if isinstance(out[0], (list, tuple)):
        return [scale[-1] for scale in out]
    return [out[-1]]


def test_spectral_conv_stride_matches_flax():
    """SpectralConv2d with stride 2 and padding 2 is flax
    nn.SpectralNorm(nn.Conv(strides=2, padding=2)): output and stored u
    (rel 1e-5)."""

    class J(fnn.Module):
        @fnn.compact
        def __call__(self, x, update_stats):
            conv = fnn.Conv(6, (4, 4), strides=(2, 2), padding=((2, 2), (2, 2)), name="conv")
            return fnn.SpectralNorm(conv)(x, update_stats=update_stats)

    x = np.random.RandomState(1).randn(2, 11, 9, 5).astype(np.float32)
    variables = _np(J().init(jax.random.PRNGKey(0), jnp.zeros((1, 11, 9, 5)), False))
    ref, new_vars = J().apply(variables, x, True, mutable=["batch_stats"])
    tm = SpectralConv2d(5, 6, 4, padding=2, stride=2)
    sd = convert.flax_to_state_dict(variables, ())
    tm.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()})
    with torch.no_grad():
        out = tm(_t(x), update_stats=True)
    _assert_rel(out.numpy(), ref, 1e-5)
    _assert_rel(tm.u.numpy(), np.asarray(new_vars["batch_stats"]["SpectralNorm_0"]["conv/kernel/u"]),
                1e-5)


# ---------------------------------------------------------------- VGG19

def _jax_vgg(seed=5):
    return _np(JVgg19Features().init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, 3))))


def test_vgg_features_match_jax(tmp_path, monkeypatch):
    """The five slice outputs (max rel 1e-5) with the JAX filters carried
    across by convert.VGG_RENAMES, and the same filters read back from the
    JAX package's .npz format by load_vgg19 (SHINEON_VGG19_WEIGHTS)."""
    variables = _jax_vgg()
    x = np.random.RandomState(2).uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    ref = JVgg19Features().apply(variables, x)
    path = tmp_path / "vgg19.npz"
    save_vgg19_params(variables, str(path))
    monkeypatch.setenv("SHINEON_VGG19_WEIGHTS", str(path))
    monkeypatch.delenv("SHINEON_ALLOW_RANDOM_VGG", raising=False)
    from_npz = load_vgg19()
    converted = Vgg19Features()
    convert.load_flax(converted, variables, convert.VGG_RENAMES)
    for model in (converted, from_npz):
        with torch.no_grad():
            out = model(_t(x))
        assert len(out) == 5
        for o, r in zip(out, ref):
            _assert_rel(o.numpy(), r, 1e-5)
    assert not any(p.requires_grad for p in from_npz.parameters())


@pytest.mark.parametrize("layids", [(0, 1, 2, 3), None], ids=["relu1-4", "all"])
def test_vgg_loss_matches_jax(layids):
    """The perceptual loss and its gradient with respect to the generated
    image (the target's features detached) against JAX's VGGLoss, same
    filters: the loss within rel 1e-5; the gradient through relu1_1 ..
    relu4_1 within 1e-5 of its max, through all five within 1e-2. At 32x24
    relu5_1 holds 1024 values, and at these inputs one of its relu kinks
    lies within an f32 rounding of zero: the two frameworks take opposite
    sides of it, which moves the whole gradient by 2e-3 of its max."""
    variables = _jax_vgg(6)
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    jvgg = JVGGLoss(variables=variables, layids=layids)
    ref, jg = jax.value_and_grad(lambda a: jvgg(a, jnp.asarray(y)))(jnp.asarray(x))
    model = Vgg19Features()
    convert.load_flax(model, variables, convert.VGG_RENAMES)
    xt = _t(x).requires_grad_()
    out = VGGLoss(model.requires_grad_(False), layids)(xt, _t(y))
    (g,) = torch.autograd.grad(out, [xt])
    _assert_rel(out.detach().numpy(), ref, 1e-5)
    _assert_rel(g.numpy(), jg, 1e-5 if layids else 1e-2)
