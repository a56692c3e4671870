"""Dataset helpers (counterpart of shineon_tpu/datasets/util.py; reference
datasets/util.py:6-22): the cloth segmentation is a device op, re-exported
here."""

from shineon_tpu_torch.ops.image_ops import segment_cloths_from_image  # noqa: F401
