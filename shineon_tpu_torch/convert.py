"""Weight bridge: the JAX package's flax variable trees -> this package's
``state_dict``s, for the SAMS generator, the GMM (its running statistics
too, as a training step leaves them), the two discriminators, the VGG19
features and TOM's U-Net.

Input is ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy
arrays (``jax.device_get`` of a flax tree, or an unpacked checkpoint), so
this module imports no JAX. It is the inverse direction of the torch -> flax
map in tools/convert_lightning_checkpoint.py:

* conv kernels HWIO -> OIHW; dense kernels (in, out) -> (out, in);
* batch norm ``BatchNorm_0/{scale, bias, mean, var}`` -> ``weight``,
  ``bias``, ``running_mean``, ``running_var``;
* flax ``nn.SpectralNorm`` state ``SpectralNorm_k/<conv>/kernel/{u, sigma}``
  -> the conv's ``u`` and ``sigma`` buffers.

FlowNet2 has its own map, :func:`flownet2_state_dict`, the inverse of the
JAX package's ``convert_torch_flownet2_state_dict``: its torch names are the
published checkpoint's.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch

_LEAF = {
    "kernel": "weight", "scale": "weight", "bias": "bias",
    "mean": "running_mean", "var": "running_var", "u": "u", "sigma": "sigma",
    "gamma": "gamma",  # SelfAttention's residual weight
}
# scope renames per network: (pattern, replacement) on whole path components
GENERATOR_RENAMES = ((r"SyncBatchNorm_0", "norm"),)
GMM_RENAMES = (
    (r"Conv_(\d+)", r"convs.\1"),
    (r"SyncBatchNorm_(\d+)", r"bns.\1"),
    (r"Dense_0", "linear"),
)
# the discriminators keep flax's scopes (discriminator_i/conv0 .. conv_out);
# their spectral state SpectralNorm_k/conv*/kernel/{u, sigma} maps to the
# conv's buffers like the generator's
DISCRIMINATOR_RENAMES = ()
VGG_RENAMES = ((r"conv(\d+)", r"convs.\1"),)
# the U-Net's flax tree nests each level's variables under its parent's
# ``submodule`` (model/submodule/.../downconv, upconv, down_attn, up_attn),
# as UnetGenerator's modules are nested: no renames. Its instance norms
# carry no variables
UNET_RENAMES = ()


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator:
    for key, value in tree.items():
        # flax names spectral-norm state with '/' inside one key
        path = prefix + tuple(str(key).split("/"))
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _torch_name(path: Sequence[str], renames) -> str:
    parts = []
    for part in path[:-1]:
        if part in ("BatchNorm_0", "kernel") or re.fullmatch(r"SpectralNorm_\d+", part):
            continue
        for pattern, repl in renames:
            if re.fullmatch(pattern, part):
                part = re.sub(pattern, repl, part)
                break
        parts.append(part)
    parts.append(_LEAF[path[-1]])
    return ".".join(parts)


def _torch_value(path: Sequence[str], value: np.ndarray) -> torch.Tensor:
    if path[-1] == "kernel":
        value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
    return torch.from_numpy(np.array(value, dtype=np.float32, order="C"))


def flax_to_state_dict(variables: Mapping, renames) -> Dict[str, torch.Tensor]:
    """Map every leaf of ``params`` and ``batch_stats`` to a state_dict entry."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            name = _torch_name(path, renames)
            if name in out:
                raise ValueError(f"two flax variables map to {name}")
            out[name] = _torch_value(path, value)
    return out


def load_flax(module: torch.nn.Module, variables: Mapping, renames) -> None:
    """Load converted flax variables into ``module``; every entry of the
    module's state_dict must be covered and every variable used."""
    module.load_state_dict(flax_to_state_dict(variables, renames), strict=True)


# FlowNet2: flax sub-network scope -> the checkpoint's submodule name
FLOWNET2_NETS = {"flownetc": "flownetc", "flownets1": "flownets_1", "flownets2": "flownets_2",
                 "flownets_d": "flownets_d", "flownetfusion": "flownetfusion"}


def flownet2_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX FlowNet2's ``params`` -> a ``state_dict`` with the key layout
    of the published flownet2-pytorch checkpoint
    (:class:`shineon_tpu_torch.networks.flownet.FlowNet2`):

    * ``flownets1`` / ``flownets2`` -> ``flownets_1`` / ``flownets_2``, and
      the ``refine`` scope of FlowNetC/S -> the sub-network's top level;
    * ``conv*``, ``deconv*`` and ``inter_conv*`` are the first layer of a
      ``Sequential`` (``conv1.0.weight``); ``predict_flow*`` and
      ``upsampled_flow*`` are bare layers;
    * conv kernels HWIO -> OIHW; deconv kernels (kh, kw, in, out) -> torch's
      (in, out, kh, kw) with the taps flipped back;
    * the ``upsampled_flow*`` deconvs have no bias in the checkpoint: their
      flax biases are dropped if they are exactly zero (as flax initialises
      them) and raise otherwise.
    """
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params):
        net, *scope, layer, leaf = path
        if scope not in ([], ["refine"]):
            raise ValueError(f"unexpected FlowNet2 scope {'/'.join(path)}")
        transposed = layer.startswith(("deconv", "upsampled_flow"))
        if layer.startswith("upsampled_flow") and leaf == "bias":
            if np.any(value != 0):
                raise ValueError(f"{'/'.join(path)} is nonzero; the checkpoint's "
                                 f"{layer} has no bias")
            continue
        if leaf == "kernel":
            value = (value.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1] if transposed
                     else value.transpose(3, 2, 0, 1))
        sequential = layer.startswith(("conv", "deconv", "inter_conv"))
        name = ".".join([FLOWNET2_NETS[net], layer] + (["0"] if sequential else []) + [_LEAF[leaf]])
        out[name] = torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
    return out


# ------------------------------------------------------ a JAX train state

# each train-state network's renames (the JAX and the port name them alike)
TRAIN_STATE_RENAMES = {"gmm": GMM_RENAMES, "unet": UNET_RENAMES, "generator": GENERATOR_RENAMES,
                       "d_multi": DISCRIMINATOR_RENAMES, "d_temporal": DISCRIMINATOR_RENAMES}


def _unflatten(flat: Mapping[str, np.ndarray], prefix: str) -> Dict:
    """The entries of ``flat`` under ``prefix`` as a nested dict of their
    remaining '/'-separated path."""
    tree: Dict = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            *scopes, leaf = key[len(prefix):].split("/")
            node = tree
            for scope in scopes:
                node = node.setdefault(scope, {})
            node[leaf] = value
    return tree


def _moments(flat, prefix: str, module: torch.nn.Module, renames):
    """An optax moment tree (``prefix`` + a parameter's flax path) as tensors
    in ``module.parameters()``'s order."""
    by_name = flax_to_state_dict({"params": _unflatten(flat, prefix)}, renames)
    names = [name for name, _ in module.named_parameters()]
    if sorted(by_name) != sorted(names):
        raise ValueError(f"{prefix} does not hold one entry a parameter of the module")
    return [by_name[name] for name in names]


@torch.no_grad()
def load_jax_train_state(flat: Mapping[str, np.ndarray], template):
    """Load the JAX package's ``TrainState``, flattened to '/'-joined paths
    (``flax.traverse_util.flatten_dict(flax.serialization.to_state_dict(state),
    sep="/")`` of an orbax restore, e.g. an ``.npz``), into ``template`` (a
    port :class:`~shineon_tpu_torch.training.state.TrainState` from the
    model's ``init_state``, on any device), in place, and return it. For
    every network of the template it maps:

    * ``nets/<net>/params`` and ``nets/<net>/stats/batch_stats`` (running
      statistics, spectral ``u`` and ``sigma``) onto the module's
      ``state_dict`` (:func:`flax_to_state_dict`, strictly);
    * optax's Adam state, ``opt_state/0/{count, mu, nu}`` (under
      ``opt_state/inner_opt_state/`` with ``--accumulated_batches`` > 1),
      onto the optimizer's count and moments, and optax.MultiSteps'
      ``acc_grads`` and ``mini_step`` onto :class:`MultiSteps`' running mean
      and mini-step count;
    * ``step`` onto the state's step.

    The state must hold the template's networks and no other, and an
    accumulating optimizer exactly where the template has one."""
    nets = sorted({key.split("/")[1] for key in flat if key.startswith("nets/")})
    if nets != sorted(template.nets):
        raise ValueError(f"the JAX state holds {nets}, the template {sorted(template.nets)}")
    for name, net in template.nets.items():
        renames, root = TRAIN_STATE_RENAMES[name], f"nets/{name}/"
        variables = {"params": _unflatten(flat, root + "params/"),
                     "batch_stats": _unflatten(flat, root + "stats/batch_stats/")}
        net.module.load_state_dict(flax_to_state_dict(variables, renames), strict=True)
        accumulating = any(k.startswith(root + "opt_state/acc_grads/") for k in flat)
        if accumulating != hasattr(net.optimizer, "acc"):
            raise ValueError(f"{name}: the JAX optimizer {'does' if accumulating else 'does not'} "
                             f"accumulate gradients; the template's optimizer "
                             f"{'does not' if accumulating else 'does'}")
        adam_root = root + ("opt_state/inner_opt_state/0/" if accumulating else "opt_state/0/")
        adam = net.optimizer.inner if accumulating else net.optimizer
        for slot in ("mu", "nu"):
            for mine, theirs in zip(getattr(adam, slot),
                                    _moments(flat, adam_root + slot + "/", net.module, renames)):
                mine.copy_(theirs)
        adam.count = int(flat[adam_root + "count"])
        if accumulating:
            acc = _moments(flat, root + "opt_state/acc_grads/", net.module, renames)
            for mine, theirs in zip(net.optimizer.acc, acc):
                mine.copy_(theirs)
            net.optimizer.mini_step = int(flat[root + "opt_state/mini_step"])
    template.step = int(flat["step"])
    return template
