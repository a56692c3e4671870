"""Convert a torchvision VGG19 ``state_dict`` into the ``.npz`` that the
perceptual loss reads (counterpart of the repository's
tools/convert_vgg19.py, without JAX):

    python -m shineon_tpu_torch.tools.convert_vgg19 vgg19.pth vgg19_imagenet.npz
    export SHINEON_VGG19_WEIGHTS=$PWD/vgg19_imagenet.npz

The reference's VGGLoss builds ``torchvision.models.vgg19(pretrained=True)``
(reference models/networks/vgg.py:6-36, loss.py:110). ``vgg19.pth`` is that
model's ``state_dict`` saved on a machine that has it (``torch.save(
torchvision.models.vgg19(weights="IMAGENET1K_V1").state_dict(),
"vgg19.pth")``); nothing is downloaded here. Full-model keys
(``features.0.weight``), bare ``features`` keys (``0.weight``) and a
wrapper dict with a ``state_dict`` entry are accepted. The ``.npz`` is the
JAX package's format: ``conv{i}/kernel`` (HWIO) and ``conv{i}/bias`` for
the 13 convs of VGG19's ``features`` up to relu5_1, read by
``shineon_tpu_torch.networks.vgg.load_vgg19`` (which loads it strictly
into its Vgg19Features, so a wrong shape fails there).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

# torchvision's vgg19 ``features`` indices of the convs up to relu5_1
CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)


def convert_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """A vgg19 ``state_dict`` -> the flat ``.npz`` entries (kernels OIHW ->
    HWIO)."""
    flat = {}
    for new_i, torch_i in enumerate(CONV_INDICES):
        for prefix in (f"features.{torch_i}.", f"{torch_i}."):
            if prefix + "weight" in state_dict:
                w = np.asarray(state_dict[prefix + "weight"], np.float32)
                flat[f"conv{new_i}/kernel"] = np.transpose(w, (2, 3, 1, 0))
                flat[f"conv{new_i}/bias"] = np.asarray(state_dict[prefix + "bias"], np.float32)
                break
        else:
            raise KeyError(f"missing vgg19 conv {torch_i} in state_dict")
    return flat


def convert(src: str, dst: str) -> None:
    import torch

    from shineon_tpu_torch import convert as bridge
    from shineon_tpu_torch.networks.vgg import Vgg19Features

    state_dict = torch.load(src, map_location="cpu", weights_only=True)
    if isinstance(state_dict, dict) and "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    flat = convert_state_dict({k: v.numpy() for k, v in state_dict.items()
                               if hasattr(v, "numpy")})
    # the converted entries must fill Vgg19Features exactly
    params = {}
    for key, value in flat.items():
        scope, leaf = key.rsplit("/", 1)
        params.setdefault(scope, {})[leaf] = value
    bridge.load_flax(Vgg19Features(), {"params": params}, bridge.VGG_RENAMES)
    np.savez(dst, **flat)
    print(f"wrote {dst}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("src", help="torch .pth state dict (vgg19)")
    parser.add_argument("dst", help="output .npz path")
    args = parser.parse_args(argv)
    convert(args.src, args.dst)


if __name__ == "__main__":
    main()
