"""Model registry (counterpart of shineon_tpu/models/__init__.py):
``find_model_using_name("warp")`` imports
``shineon_tpu_torch.models.warp_model`` and returns its ``BaseModel``
subclass whose lowercased name is ``warpmodel``; ``get_option_setter`` its
``modify_commandline_options``."""

from __future__ import annotations

import importlib


def find_model_using_name(model_name: str):
    from shineon_tpu_torch.models.base_model import BaseModel

    module = "shineon_tpu_torch.models." + model_name + "_model"
    modellib = importlib.import_module(module)
    target = model_name.replace("_", "") + "model"
    for name, cls in modellib.__dict__.items():
        if name.lower() == target and isinstance(cls, type) and issubclass(cls, BaseModel):
            return cls
    raise NotImplementedError(
        f"module {module} does not define a BaseModel subclass whose lowercased name "
        f"equals {target!r}")


def get_option_setter(model_name: str):
    return find_model_using_name(model_name).modify_commandline_options
