"""The port's SAMS initial state against SamsModel.init_state of the JAX
package on the CPU, at tiny widths (test_torch_training's TINY_TRAIN): the
spectral convs' stored kernels, the orthogonal init, and the batch-norm
discriminators both packages refuse.

flax's nn.SpectralNorm initializes through ``map_variables(..., init=True,
mutable=True)``, which writes the normalized kernel W / sigma back into the
parameters, sigma from one power step from the stored ``u``. So a fresh
spectral kernel's scale is the power step's, not its init law's gain. The
two frameworks draw different numbers, so the tests compare laws: the
largest singular value of each spectral kernel, and which init types give
the same kernel from one draw."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ModifyScopeVariableError

from __graft_entry__ import _sams_opt
from shineon_tpu.models.sams_model import SamsModel as JSamsModel
from shineon_tpu_torch import convert
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.networks.init import kernel_init_
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.normalization import SpectralConv2d
from shineon_tpu_torch.options import sams_options
from test_torch_networks import _np, one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import NETS, TINY_TRAIN

INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal", "none")
# a spectral kernel's largest singular value over its draws (one power
# step from a random u underestimates sigma by a random factor): 1.04 to
# 1.46 for single convs of 8 to 64 channels here, both packages; the mean
# over a network's convs and two draws lies within a few percent of the
# law's, so the two packages' means agree within MEAN_TOLERANCE
MEAN_TOLERANCE = 0.10
PORT_SEEDS = (0, 1)


def spectral_sigmas(model):
    """{network: [largest singular value of each spectral kernel]}, in
    module order, the 1-channel output convs left out (their sigma is 1
    by construction)."""
    out = {}
    for attr in ("generator", "multiscale_discriminator", "temporal_discriminator"):
        sigmas = []
        for m in getattr(model, attr).modules():
            if isinstance(m, SpectralConv2d) and m.weight.shape[0] > 1:
                w = m.weight.detach().double().reshape(m.weight.shape[0], -1)
                sigmas.append(torch.linalg.matrix_norm(w, 2).item())
        out[attr] = sigmas
    return out


@functools.lru_cache(maxsize=None)
def jax_model(init_type):
    """A port model holding the JAX package's initial state for
    ``init_type`` from PRNGKey(0), carried across with convert: for xavier
    (the default) SamsModel.init_state's; for the others the
    discriminators' inits as init_state makes them (its keys and inputs),
    beside the xavier state's generator (flax's defaults whatever the
    init_type, in both packages), to spare a generator compile a type."""
    jm = JSamsModel(_sams_opt(**TINY_TRAIN, init_type=init_type))
    model = SamsModel(sams_options(**TINY_TRAIN, init_type=init_type), device="cpu")
    if init_type == "xavier":
        state = jm.init_state(jax.random.PRNGKey(0), 1)
        variables = {name: {"params": _np(net.params), **_np(net.stats)}
                     for name, net in state.nets.items()}
    else:
        model.generator.load_state_dict(jax_model("xavier").generator.state_dict())
        rngs = jax.random.split(jax.random.PRNGKey(0), 3)
        H, W = TINY_TRAIN["fine_height"], TINY_TRAIN["fine_width"]
        sem_ch = jm.person_channels + jm.cloth_channels
        variables = {
            "d_multi": _np(jax.jit(jm.multiscale_discriminator.init)(
                rngs[1], jnp.zeros((2, H, W, sem_ch + 3)))),
            "d_temporal": _np(jax.jit(jm.temporal_discriminator.init)(
                rngs[2], jnp.zeros((2, H, W, jm.temporal_in_channels)))),
        }
    for name, tree in variables.items():
        attr, renames = NETS[name]
        convert.load_flax(getattr(model, attr), tree, renames)
    return model


@functools.lru_cache(maxsize=None)
def port_model(init_type, seed, norm_D="spectralinstance"):
    """The port's SamsModel after init_state from ``seed`` (read only)."""
    model = SamsModel(sams_options(**TINY_TRAIN, init_type=init_type, norm_D=norm_D),
                      device="cpu")
    model.init_state(torch.Generator().manual_seed(seed), 1)
    return model


@pytest.mark.parametrize("init_type", INIT_TYPES)
def test_spectral_init_law_matches_jax(init_type):
    """Every spectral conv of the generator and both discriminators stores
    W / sigma: the mean of their largest singular values per network
    agrees with the JAX package's within MEAN_TOLERANCE (a raw draw, the
    fault this repairs, reads 0.02 to 1.3 here); orthogonal kernels are
    exactly orthonormal in both (sigma 1). The stored u is the draw and
    sigma 1, as flax leaves them when it initializes without update_stats."""
    ref = spectral_sigmas(jax_model(init_type))
    ports = [port_model(init_type, seed) for seed in PORT_SEEDS]
    outs = [spectral_sigmas(m) for m in ports]
    for attr, sigmas in ref.items():
        assert sigmas and all(len(o[attr]) == len(sigmas) for o in outs)
        mine = np.mean([o[attr] for o in outs])
        assert abs(mine / np.mean(sigmas) - 1) <= MEAN_TOLERANCE, (attr, mine, np.mean(sigmas))
        # a power step's sigma never exceeds the largest singular value
        assert all(s >= 1.0 - 1e-4 for o in outs for s in o[attr])
        if init_type == "orthogonal" and attr != "generator":
            np.testing.assert_allclose(sigmas, 1.0, atol=1e-5)
            np.testing.assert_allclose([s for o in outs for s in o[attr]], 1.0, atol=1e-5)
    for m in (m for net in NETS.values() for m in getattr(ports[0], net[0]).modules()):
        if isinstance(m, SpectralConv2d):
            assert m.sigma.item() == 1.0
            assert 0.0 < m.u.norm().item() and abs(m.u.norm().item() - 1.0) > 1e-3


def test_gain_laws_give_the_same_spectral_kernels():
    """normal, xavier and kaiming draw one standard normal scaled by a
    gain, which the stored W / sigma divides out: the discriminators'
    kernels from one seed agree in both packages (to f32 rounding)."""
    for make in (lambda it: port_model(it, PORT_SEEDS[0]), jax_model):
        models = [make(it) for it in ("normal", "xavier", "kaiming")]
        for attr in ("multiscale_discriminator", "temporal_discriminator"):
            kernels = [[m.weight.detach() for m in getattr(model, attr).modules()
                        if isinstance(m, SpectralConv2d)] for model in models]
            for other in kernels[1:]:
                for a, b in zip(kernels[0], other):
                    torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("shape", [(64, 32, 4, 4), (8, 15, 4, 4), (1, 64, 4, 4), (16, 300)],
                         ids=["tall", "tall-odd", "wide-column", "dense"])
def test_orthogonal_init_is_gain_times_orthonormal(shape):
    """``--init_type orthogonal``: the kernel in the JAX package's (kh*kw*cin,
    cout) view (a dense (in, out)) has orthonormal columns (orthonormal
    rows when it is wide) times the gain, as
    jax.nn.initializers.orthogonal(scale=gain) gives it."""
    gain = 0.02
    w = torch.empty(shape)
    kernel_init_(w, "orthogonal", gain, torch.Generator().manual_seed(0))
    m = (w.permute(2, 3, 1, 0).reshape(-1, shape[0]) if w.dim() == 4 else w.t()).double()
    ref = np.asarray(jax.nn.initializers.orthogonal(scale=gain)(
        jax.random.PRNGKey(0), (*shape[2:], shape[1], shape[0]) if len(shape) == 4
        else shape[::-1]), np.float64).reshape(m.shape)
    for q in (m.numpy(), ref):
        gram = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
        np.testing.assert_allclose(gram, gain ** 2 * np.eye(len(gram)), atol=1e-9)


def test_orthogonal_init_through_init_state():
    """Through init_state: under a spectral norm_D (the default) every
    discriminator kernel has sigma 1.000; under ``instance`` (plain convs)
    it keeps the gain, sigma 0.02."""
    for norm_D, sigma in (("spectralinstance", 1.0), ("instance", 0.02)):
        model = port_model("orthogonal", 0, norm_D=norm_D)
        convs = [m for d in (model.multiscale_discriminator, model.temporal_discriminator)
                 for m in d.modules() if isinstance(m, (Conv2d, SpectralConv2d))]
        assert convs
        for m in convs:
            w = m.weight.detach().double().reshape(m.weight.shape[0], -1)
            assert abs(torch.linalg.matrix_norm(w, 2).item() - sigma) <= 1e-5 * sigma


def test_batch_norm_D_refused_by_both():
    """``--norm_D spectralsync_batch`` (and ``batch``): the JAX package's
    discriminate() applies a train-mode SyncBatchNorm without a mutable
    batch_stats and raises ModifyScopeVariableError in every SAMS step;
    the port refuses the option when it builds the discriminators."""
    for norm_D in ("spectralsync_batch", "batch"):
        jm = JSamsModel(_sams_opt(**TINY_TRAIN, norm_D=norm_D))
        disc = jm.multiscale_discriminator
        H, W = TINY_TRAIN["fine_height"], TINY_TRAIN["fine_width"]
        sem = jnp.zeros((1, H, W, jm.person_channels + jm.cloth_channels))
        frame = jnp.zeros((1, H, W, 3))
        variables = jax.jit(disc.init)(jax.random.PRNGKey(0), jnp.concatenate([sem, frame], -1))
        with pytest.raises(ModifyScopeVariableError, match="batch_stats"):
            jm.discriminate(disc, variables, sem, frame, frame)
        with pytest.raises(ValueError, match="norm_D"):
            SamsModel(sams_options(**TINY_TRAIN, norm_D=norm_D), device="cpu")
