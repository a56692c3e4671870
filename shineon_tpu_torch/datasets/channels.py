"""Channel-count constants for every input kind (reference:
datasets/tryon_dataset.py:47-61) + parse_num_channels (tryon_dataset.py:540-547).

Kept in a leaf module so both the network layer and the data layer can use them
without circular imports.
"""

from __future__ import annotations

from typing import Iterable, Union

RGB_CHANNELS = 3
MASK_CHANNELS = 1

COCOPOSE_CHANNELS = 18
IM_HEAD_CHANNELS = RGB_CHANNELS
SILHOUETTE_CHANNELS = MASK_CHANNELS

AGNOSTIC_CHANNELS = IM_HEAD_CHANNELS + SILHOUETTE_CHANNELS  # 4

CLOTH_CHANNELS = RGB_CHANNELS
CLOTH_MASK_CHANNELS = MASK_CHANNELS

DENSEPOSE_CHANNELS = 3

FLOW_CHANNELS = 2

IMAGE_CHANNELS = RGB_CHANNELS
PREV_IMAGE_CHANNELS = RGB_CHANNELS
IM_CLOTH_CHANNELS = RGB_CHANNELS


def channels_for(name: str) -> int:
    key = f"{name.upper()}_CHANNELS"
    value = globals().get(key)
    if value is None:
        raise AttributeError(f"no channel constant for input '{name}'")
    return value


def parse_num_channels(list_of_inputs: Union[str, Iterable[str]]) -> int:
    """Total channels of a set of named inputs (tryon_dataset.py:540-547)."""
    if isinstance(list_of_inputs, str):
        list_of_inputs = [list_of_inputs]
    return sum(channels_for(inp) for inp in list_of_inputs)
