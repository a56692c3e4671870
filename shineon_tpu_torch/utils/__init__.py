"""Small shared helpers (counterpart of shineon_tpu/utils/__init__.py;
reference util/__init__.py:8-60). ``get_and_cat_inputs`` is in
:mod:`shineon_tpu_torch.models.base_model`."""

from __future__ import annotations

import importlib
from typing import List, Tuple, Union


def find_class_in_module(target_cls_name: str, module: str):
    """Case- and underscore-insensitive class lookup inside a module."""
    target_cls_name = target_cls_name.replace("_", "").lower()
    clslib = importlib.import_module(module)
    for name, clsobj in clslib.__dict__.items():
        if name.lower() == target_cls_name:
            return clsobj
    raise ImportError(
        f"module {module} defines no class whose lowercased, "
        f"underscore-free name equals {target_cls_name!r}")


def str2num(s: Union[str, int, float]) -> Union[int, float]:
    """An option string as int if it parses as one, else float."""
    if isinstance(s, (int, float)):
        return s
    try:
        return int(s)
    except ValueError:
        return float(s)


def get_prev_data_zero_bounded(data: Union[List, Tuple], end_idx: int, num_frames: int):
    """The ``num_frames`` items ending before ``end_idx``, item 0 repeated at
    the left boundary."""
    start_idx = end_idx - num_frames + 1
    prev_n_data = data[max(0, start_idx): end_idx]
    if not isinstance(prev_n_data, (list, tuple)):
        prev_n_data = [prev_n_data]
    if start_idx < 0:
        prev_n_data = [data[0] for _ in range(abs(start_idx))] + list(prev_n_data)
    return prev_n_data
