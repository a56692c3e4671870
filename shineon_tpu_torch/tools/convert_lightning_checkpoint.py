"""Convert a reference PyTorch-Lightning checkpoint into a port checkpoint
(counterpart of the repository's tools/convert_lightning_checkpoint.py):

    python -m shineon_tpu_torch.tools.convert_lightning_checkpoint \
        --model {warp,unet_mask,sams} --ckpt model.ckpt --out DIR [test options]

The reference's ``.ckpt`` (SURVEY §5.4; the published weights,
docs/2_inference.md:3-5) holds a torch ``state_dict`` named after the
reference's classes. Its names are mapped in two steps: first onto the JAX
package's flax tree (a copy of the JAX tool's maps, below: the GMM's
FeatureExtraction and FeatureRegression plans, the U-Net's nested blocks,
the SAMS generator's encode/middle/decode lists with ``encode_extra`` and
``decode_extra`` when the widths need them), then by
:mod:`shineon_tpu_torch.convert` onto the port's modules. The layouts:

  * conv kernels stay OIHW (the flax tree takes them to HWIO and
    ``convert`` back);
  * BatchNorm ``weight``/``bias`` and ``running_mean``/``running_var`` are
    the port's SyncBatchNorm's;
  * FeatureRegression's dense layer: the reference flattens NCHW, and so
    does the port's (``networks/cpvton/warp.py``), so its weight is taken
    as it is;
  * a ``spectral_norm`` conv: ``weight_orig`` becomes the conv's weight and
    ``weight_u`` its ``u``, with sigma = u W v from torch's power state. The
    port, like flax's ``SpectralNorm``, takes one more power step from that
    ``u`` at every call; with a converged checkpoint that changes sigma
    negligibly. (Only a fresh init stores W / sigma: a loaded weight is the
    checkpoint's.)

The model is then built from the test options (``--model`` and whatever
else follows on the command line; for SAMS the architecture powers default
to the checkpoint's hyper-parameters), the converted weights are loaded
strictly (every entry of the model's ``state_dict`` covered, every
converted tensor used), and the state is written to ``DIR/state.pt`` with
fresh optimizers at step 0: ``python -m shineon_tpu_torch.test --checkpoint
DIR`` restores it. No file is downloaded: the checkpoint is a local file.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Tuple

import numpy as np

from shineon_tpu_torch import convert

# the model option -> (the port's net name, convert's renames)
NETS = {"warp": ("gmm", convert.GMM_RENAMES), "unet_mask": ("unet", convert.UNET_RENAMES),
        "sams": ("generator", convert.GENERATOR_RENAMES)}
SAMS_ARCH = ("ngf_base", "ngf_pow_outer", "ngf_pow_inner", "ngf_pow_step")


def _np(value) -> np.ndarray:
    return np.asarray(value.detach().cpu().numpy() if hasattr(value, "detach") else value)


def _conv(sd, prefix) -> Dict[str, np.ndarray]:
    out = {"kernel": np.transpose(_np(sd[prefix + ".weight"]), (2, 3, 1, 0))}
    if prefix + ".bias" in sd:
        out["bias"] = _np(sd[prefix + ".bias"])
    return out


def _bn(sd, prefix) -> Tuple[Dict, Dict]:
    params = {"scale": _np(sd[prefix + ".weight"]), "bias": _np(sd[prefix + ".bias"])}
    stats = {"mean": _np(sd[prefix + ".running_mean"]), "var": _np(sd[prefix + ".running_var"])}
    return params, stats


# --------------------------------------------------------------- GMM (warp)

def _sequential(sd, prefix: str, conv_idx, bn_idx):
    params, stats = {}, {}
    for i, t in enumerate(conv_idx):
        params[f"Conv_{i}"] = _conv(sd, f"{prefix}.{t}")
    for i, t in enumerate(bn_idx):
        p, s = _bn(sd, f"{prefix}.{t}")
        params[f"SyncBatchNorm_{i}"] = {"BatchNorm_0": p}
        stats[f"SyncBatchNorm_{i}"] = {"BatchNorm_0": s}
    return params, stats


def convert_warp_state_dict(state_dict) -> Dict:
    """Reference WarpModel state_dict -> the GMM's flax tree: FeatureExtraction
    convs at 0, 3, .., 15 and norms at 2, 5, .., 14 of ``.model``
    (cpvton/warp.py:14-31); FeatureRegression convs at 0, 3, 6, 9 and norms
    at 1, 4, 7, 10 of ``.conv``, then ``.linear`` (:70-99)."""
    params, stats = {}, {}
    for member in ("extractionA", "extractionB"):
        params[member], stats[member] = _sequential(
            state_dict, f"{member}.model", [0, 3, 6, 9, 12, 15], [2, 5, 8, 11, 14])
    p, s = _sequential(state_dict, "regression.conv", [0, 3, 6, 9], [1, 4, 7, 10])
    w = _np(state_dict["regression.linear.weight"])  # (out, in)
    p["Dense_0"] = {"kernel": w.T, "bias": _np(state_dict["regression.linear.bias"])}
    params["regression"], stats["regression"] = p, s
    return {"params": params, "batch_stats": stats}


# ------------------------------------------------------------- U-Net (TOM)

def _block_children(sd, prefix: str):
    """The children of one UnetSkipConnectionBlock Sequential in order, each
    (kind, prefix), kind in conv, norm, attn, submodule (an InstanceNorm2d
    without affine has no entries)."""
    indices = {}
    pat = re.compile(re.escape(prefix) + r"\.model\.(\d+)(\.|$)")
    for key in sd:
        m = pat.match(key)
        if m:
            indices.setdefault(int(m.group(1)), []).append(key)
    children = []
    for i in sorted(indices):
        keys, base = indices[i], f"{prefix}.model.{i}"
        if any(k.startswith(base + ".model.") for k in keys):
            children.append(("submodule", base))
        elif any(k.startswith(base + ".query_conv") for k in keys):
            children.append(("attn", base))
        elif any(k == base + ".running_mean" for k in keys):
            children.append(("norm", base))
        elif any(k == base + ".weight" for k in keys):
            children.append(("conv", base))
    return children


def _attn_params(sd, prefix: str):
    out = {name: _conv(sd, f"{prefix}.{name}") for name in ("query_conv", "key_conv",
                                                             "value_conv")}
    out["gamma"] = _np(sd[prefix + ".gamma"]).reshape(1)
    return out


def convert_unet_block(sd, prefix: str):
    """One UnetSkipConnectionBlock (cpvton/unet.py:103-198), recursively:
    downconv [, norm][, down_attn][, submodule], upconv [, norm][, up_attn]."""
    params, stats = {}, {}
    conv_seen = norm_seen = 0
    before_upconv = True
    for kind, base in _block_children(sd, prefix):
        if kind == "conv":
            conv_seen += 1
            params["downconv" if conv_seen == 1 else "upconv"] = _conv(sd, base)
            before_upconv = conv_seen == 1
        elif kind == "attn":
            params["down_attn" if before_upconv and conv_seen == 1 else "up_attn"] = \
                _attn_params(sd, base)
        elif kind == "norm":
            p, s = _bn(sd, base)
            params[f"SyncBatchNorm_{norm_seen}"] = {"BatchNorm_0": p}
            stats[f"SyncBatchNorm_{norm_seen}"] = {"BatchNorm_0": s}
            norm_seen += 1
        else:
            params["submodule"], sub_stats = convert_unet_block(sd, base)
            if sub_stats:
                stats["submodule"] = sub_stats
            before_upconv = False
    return params, stats


def convert_unet_state_dict(state_dict, torch_prefix: str = "unet") -> Dict:
    """Reference UnetGenerator state_dict (TOM, instance norm) -> its flax tree."""
    params, stats = convert_unet_block(state_dict, f"{torch_prefix}.model")
    out = {"params": {"model": params}}
    if stats:
        out["batch_stats"] = {"model": stats}
    return out


# ------------------------------------------------------------ SAMS generator

def _spectral_conv(sd, prefix: str, has_bias: bool = True):
    """A torch ``spectral_norm`` conv -> (params, (sigma, u)): the kernel is
    ``weight_orig``, sigma = u W v from torch's power state."""
    w = _np(sd[prefix + ".weight_orig"])
    u = _np(sd[prefix + ".weight_u"])  # (out_channels,)
    v = _np(sd[prefix + ".weight_v"])
    sigma = float(u @ (w.reshape(w.shape[0], -1) @ v))
    params = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    if has_bias and prefix + ".bias" in sd:
        params["bias"] = _np(sd[prefix + ".bias"])
    return params, (sigma, u.reshape(1, -1).astype(np.float32))


def _spade(sd, prefix: str):
    """One SPADE (sams/spade.py:61-103): the param-free norm's running
    statistics and the mlp_shared/gamma/beta convs."""
    params = {"mlp_shared": _conv(sd, f"{prefix}.mlp_shared.0"),
              "mlp_gamma": _conv(sd, f"{prefix}.mlp_gamma"),
              "mlp_beta": _conv(sd, f"{prefix}.mlp_beta")}
    stats = {}
    if f"{prefix}.param_free_norm.running_mean" in sd:
        stats["SyncBatchNorm_0"] = {"BatchNorm_0": {
            "mean": _np(sd[f"{prefix}.param_free_norm.running_mean"]),
            "var": _np(sd[f"{prefix}.param_free_norm.running_var"])}}
    return params, stats


def _spade_stack(sd, prefix: str):
    """SPADE, MultiSpade or AttentiveMultiSpade, by their entries."""
    if f"{prefix}.mlp_shared.0.weight" in sd:
        return _spade(sd, prefix)
    params, stats = {}, {}
    depth = len(prefix.split(".")) + 1
    for key in sorted({k.split(".")[depth] for k in sd if k.startswith(prefix + ".spade_layers.")}):
        p, s = _spade(sd, f"{prefix}.spade_layers.{key}")
        params[f"spade_{key}"] = p
        if s:
            stats[f"spade_{key}"] = s
    if f"{prefix}.attention_layer.query_conv.weight" in sd:
        params["attention_layer"] = _attn_params(sd, f"{prefix}.attention_layer")
        params["mlp_final"] = _conv(sd, f"{prefix}.mlp_final.0")
    return params, stats


def _spade_resblock(sd, prefix: str):
    """AnySpadeResBlock (sams/spade.py:106-192); the spectral entries in the
    flax call order, the shortcut first."""
    params, stats = {}, {}
    spectral = []
    if f"{prefix}.conv_s.weight_orig" in sd:  # a learned shortcut
        params["conv_s"], sn = _spectral_conv(sd, f"{prefix}.conv_s", has_bias=False)
        spectral.append(("conv_s", sn))
        params["norm_s"], s = _spade_stack(sd, f"{prefix}.norm_s")
        if s:
            stats["norm_s"] = s
    for conv in ("conv_0", "conv_1"):
        if f"{prefix}.{conv}.weight_orig" in sd:
            params[conv], sn = _spectral_conv(sd, f"{prefix}.{conv}")
            spectral.append((conv, sn))
        else:  # a norm_G without spectral
            params[conv] = _conv(sd, f"{prefix}.{conv}")
    for spade in ("spade_0", "spade_1"):
        params[spade], s = _spade_stack(sd, f"{prefix}.{spade}")
        if s:
            stats[spade] = s
    for i, (conv, (sigma, u)) in enumerate(spectral):
        stats[f"SpectralNorm_{i}"] = {f"{conv}/kernel/sigma": np.asarray(sigma, np.float32),
                                      f"{conv}/kernel/u": u}
    return params, stats


def has_extra(ngf_base: int, ngf_pow_outer: int, ngf_pow_inner: int, ngf_pow_step: int) -> bool:
    """Whether the encoder's steps miss ngf_base ** ngf_pow_inner, so that an
    ``encode_extra`` (and a ``decode_extra``) block closes the gap."""
    steps = len(range(ngf_pow_outer, ngf_pow_inner, ngf_pow_step))
    return int(ngf_base ** (ngf_pow_outer + steps * ngf_pow_step)) != int(
        ngf_base ** ngf_pow_inner)


def convert_sams_generator_state_dict(state_dict, torch_prefix: str = "generator",
                                      ngf_base: int = 2, ngf_pow_outer: int = 6,
                                      ngf_pow_inner: int = 10, ngf_pow_step: int = 1) -> Dict:
    """Reference SamsGenerator state_dict -> its flax tree. The reference's
    lists (sams_generator.py:133-212): encode_layers = [Conv2d] + [resblock,
    Upsample]*, middle_layers = [resblock]*, decode_layers = [Upsample,
    resblock]* + [Conv2d]; with :func:`has_extra` the last resblock of the
    encoder and of the decoder is ``encode_extra`` / ``decode_extra``."""
    params, stats = {}, {}
    extra = has_extra(ngf_base, ngf_pow_outer, ngf_pow_inner, ngf_pow_step)

    def block_indices(list_name):
        pat = re.compile(re.escape(f"{torch_prefix}.{list_name}.") + r"(\d+)\.")
        return sorted({int(m.group(1)) for m in map(pat.match, state_dict) if m})

    def blocks(list_name, positions, stem):
        for n, i in enumerate(positions):
            name = f"{stem}_extra" if extra and stem != "middle" and n == len(positions) - 1 \
                else f"{stem}_{n}"
            params[name], s = _spade_resblock(state_dict, f"{torch_prefix}.{list_name}.{i}")
            if s:
                stats[name] = s

    params["encode_conv_in"] = _conv(state_dict, f"{torch_prefix}.encode_layers.0")
    blocks("encode_layers", [i for i in block_indices("encode_layers") if i != 0], "encode")
    blocks("middle_layers", block_indices("middle_layers"), "middle")
    dec = block_indices("decode_layers")
    blocks("decode_layers", dec[:-1], "decode")
    params["decode_conv_out"] = _conv(state_dict, f"{torch_prefix}.decode_layers.{dec[-1]}")
    return {"params": params, "batch_stats": stats}


# ------------------------------------------------------------------- entry

def to_state_dict(model_name: str, state_dict, hparams=None):
    """(the port's net name, its converted ``state_dict``) of a reference
    ``state_dict``; SAMS reads its architecture powers from ``hparams``."""
    hparams = hparams or {}
    if model_name == "warp":
        variables = convert_warp_state_dict(state_dict)
    elif model_name == "unet_mask":
        variables = convert_unet_state_dict(state_dict)
    elif model_name == "sams":  # the generator: the discriminators only train
        defaults = dict(ngf_base=2, ngf_pow_outer=6, ngf_pow_inner=10, ngf_pow_step=1)
        variables = convert_sams_generator_state_dict(
            state_dict, **{k: int(hparams.get(k, v)) for k, v in defaults.items()})
    else:
        raise ValueError(f"unknown model: {model_name!r}")
    net, renames = NETS[model_name]
    return net, convert.flax_to_state_dict(variables, renames)


def convert_checkpoint(model_name: str, ckpt: str, out: str, option_argv=(), dataset="vvt"):
    """Read a Lightning ``ckpt``, convert it, load it strictly into the model
    the test options build (``--model model_name --dataset dataset`` and
    ``option_argv``, after the checkpoint's SAMS powers) on the CPU, and
    write the port checkpoint ``out``. Returns ``out``."""
    import torch

    from shineon_tpu_torch.models import find_model_using_name
    from shineon_tpu_torch.options import TestOptions
    from shineon_tpu_torch.training.checkpointing import save_checkpoint

    payload = torch.load(ckpt, map_location="cpu", weights_only=False)
    state_dict = dict(payload.get("state_dict", payload))
    hparams = payload.get("hparams", payload.get("hyper_parameters")) or {}
    hparams = dict(vars(hparams)) if isinstance(hparams, argparse.Namespace) else dict(hparams)
    argv = ["--model", model_name, "--dataset", dataset, "--name", "converted"]
    if model_name == "sams":
        argv += [a for k in SAMS_ARCH if k in hparams for a in (f"--{k}", str(hparams[k]))]
    opt = TestOptions().parse(argv + list(option_argv) + ["--gpu_ids", "-1"])
    net, converted = to_state_dict(opt.model, state_dict, {**hparams, **{
        k: getattr(opt, k) for k in SAMS_ARCH if hasattr(opt, k)}})
    model = find_model_using_name(opt.model)(opt, "cpu")
    state = model.make_state(1)
    state.nets[net].module.load_state_dict(converted, strict=True)
    return save_checkpoint(out, state)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=tuple(NETS), required=True)
    parser.add_argument("--ckpt", required=True, help="the Lightning .ckpt (a local file)")
    parser.add_argument("--out", required=True, help="the port checkpoint's directory")
    parser.add_argument("--dataset", default="vvt")
    args, option_argv = parser.parse_known_args(argv)
    out = convert_checkpoint(args.model, args.ckpt, args.out, option_argv, args.dataset)
    print(f"converted {args.model} -> {out}")


if __name__ == "__main__":
    main()
