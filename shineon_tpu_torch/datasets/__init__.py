"""Dataset registry (counterpart of shineon_tpu/datasets/__init__.py;
reference datasets/__init__.py:9-36): ``find_dataset_using_name("vvt")``
imports ``shineon_tpu_torch.datasets.vvt_dataset`` and returns its
``BaseDataset`` subclass whose lowercased name is ``vvtdataset``;
``get_option_setter`` its ``modify_commandline_options``."""

from __future__ import annotations

import importlib


def find_dataset_using_name(dataset_name: str):
    from shineon_tpu_torch.datasets.base_dataset import BaseDataset

    module = "shineon_tpu_torch.datasets." + dataset_name + "_dataset"
    datasetlib = importlib.import_module(module)
    target = dataset_name.replace("_", "") + "dataset"
    for name, cls in datasetlib.__dict__.items():
        if name.lower() == target and isinstance(cls, type) and issubclass(cls, BaseDataset):
            return cls
    raise NotImplementedError(
        f"module {module} does not define a BaseDataset subclass "
        f"whose lowercased name equals {target!r}")


def get_option_setter(dataset_name: str):
    """The dataset's ``modify_commandline_options``."""
    return find_dataset_using_name(dataset_name).modify_commandline_options
