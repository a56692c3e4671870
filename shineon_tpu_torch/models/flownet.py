"""Offline optical flow and its confidence (counterpart of
shineon_tpu/models/flownet.py): FlowNet2 on frame pairs, and the walk over
per-video frame folders that writes the ``.flo`` annotations SAMS's
``flow_warp`` configuration reads.

    net = FlowNet()                      # on the card; FlowNet(device="cpu")
    flow, conf = net(im1_u8, im2_u8)     # (B, H, W, 3) uint8 pairs
    generate_flow_annotations(frames_root, out_root)

Convolutions run at PyTorch's default precision: f32, which cuDNN computes
in TF32 on the card while ``torch.backends.cudnn.allow_tf32`` is True (its
default), as JAX's default precision lets XLA do. Nothing here sets a
global flag. The cost volume and the channel norms are exact f32.
"""

from __future__ import annotations

import logging
import math
import os
import os.path as osp
from glob import glob
from typing import Optional, Tuple

import numpy as np
import torch

from shineon_tpu_torch.datasets.flow_utils import write_flow
from shineon_tpu_torch.networks.flownet import FlowNet2
from shineon_tpu_torch.ops.grid_sample import resample2d
from shineon_tpu_torch.ops.image_ops import resize_bilinear
from shineon_tpu_torch.serving import resolve_device

logger = logging.getLogger(__name__)

WEIGHTS_ENV = "SHINEON_FLOWNET2_WEIGHTS"
CONFIDENCE_THRESHOLD = 0.02  # squared warp error on [0, 1] images


def build_flownet2(seed: Optional[int], device="cpu") -> FlowNet2:
    """FlowNet2 in channels_last memory on ``device``. With a ``seed``, its
    weights are the JAX package's random init drawn from
    ``torch.Generator().manual_seed(seed)`` on the CPU (so the same on every
    device); with None they are left uninitialised, for a state_dict to
    fill."""
    with torch.device("meta"):
        net = FlowNet2()
    net = net.to_empty(device="cpu")
    if seed is not None:
        net.init_weights(torch.Generator().manual_seed(seed))
    return net.to(device, memory_format=torch.channels_last).eval()


class FlowNet:
    """FlowNet2 flow and confidence for uint8 frame pairs (reference
    models/flownet.py:22-59). The weights come from ``checkpoint_path`` or
    the file ``$SHINEON_FLOWNET2_WEIGHTS`` names, else they are random from
    ``seed`` (with a warning). Runs on the card unless ``device`` says
    otherwise; a CUDA device that is not there raises."""

    def __init__(self, checkpoint_path: Optional[str] = None, seed: int = 420,
                 device="cuda"):
        self.device = resolve_device(device)
        path = checkpoint_path or os.environ.get(WEIGHTS_ENV, "")
        if path and osp.exists(path):
            self.model = build_flownet2(None, self.device)
            # flownet2-pytorch's main.py writes its checkpoints, and reads
            # the released ones through --resume, as a dict of "arch" (str),
            # "epoch" (int), "best_EPE" (float) and "state_dict" (an
            # OrderedDict of tensors): types weights_only=True admits, in
            # torch's legacy format too (tests/test_torch_flownet.py loads
            # such a file). Anything else in a file fails here, unexecuted.
            payload = torch.load(path, map_location="cpu", weights_only=True)
            self.model.load_state_dict(payload.get("state_dict", payload), strict=True)
            logger.info(f"FlowNet2 weights loaded from {path}")
        else:
            self.model = build_flownet2(seed, self.device)
            logger.warning(
                "FlowNet2 running with RANDOM weights (no checkpoint at "
                f"{path!r}); set {WEIGHTS_ENV} or pass checkpoint_path to "
                "produce meaningful flow.")

    @torch.no_grad()
    def __call__(self, im1_u8, im2_u8) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) uint8 frame pairs (arrays or tensors) -> flow
        (B, H, W, 2) in pixels and confidence (B, H, W, 1) in {0, 1}, f32
        tensors on the model's device. Frames are resized to multiples of
        64 (at least 64) for FlowNet2 and its flow back, its displacements
        rescaled to the frame."""
        im1 = torch.as_tensor(im1_u8).to(self.device, torch.float32)
        im2 = torch.as_tensor(im2_u8).to(self.device, torch.float32)
        H, W = im1.shape[1:3]
        H64 = max(64, math.ceil(H / 64) * 64)
        W64 = max(64, math.ceil(W / 64) * 64)
        flow = self.model(resize_bilinear(im1, (H64, W64)), resize_bilinear(im2, (H64, W64)))
        flow = resize_bilinear(flow, (H, W))
        flow = flow * torch.tensor([W / W64, H / H64], dtype=torch.float32, device=self.device)
        warped = resample2d(im2 / 255.0, flow)
        err = torch.sum((im1 / 255.0 - warped) ** 2, dim=-1, keepdim=True)
        return flow, (err < CONFIDENCE_THRESHOLD).float()


def generate_flow_annotations(frames_root: str, out_root: str,
                              checkpoint_path: Optional[str] = None, batch_size: int = 4,
                              device="cuda") -> int:
    """Walk the per-video frame folders under ``frames_root`` and write one
    ``.flo`` a consecutive frame pair, named after its first frame, under
    ``out_root/<video>/`` (docs/1_installation_and_data.md). Pairs go
    through FlowNet in batches of ``batch_size``. Returns the number of
    files written."""
    from PIL import Image

    net = FlowNet(checkpoint_path, device=device)
    written = 0
    for video in sorted(os.listdir(frames_root)):
        vdir = osp.join(frames_root, video)
        if not osp.isdir(vdir):
            continue
        frames = sorted(glob(osp.join(vdir, "*.png")))
        out_dir = osp.join(out_root, video)
        os.makedirs(out_dir, exist_ok=True)
        pairs = list(zip(frames[:-1], frames[1:]))
        for i in range(0, len(pairs), batch_size):
            chunk = pairs[i:i + batch_size]
            im1 = np.stack([np.asarray(Image.open(a).convert("RGB")) for a, _ in chunk])
            im2 = np.stack([np.asarray(Image.open(b).convert("RGB")) for _, b in chunk])
            flow, _ = net(im1, im2)
            for (a, _), f in zip(chunk, flow.cpu().numpy()):
                write_flow(osp.join(out_dir, osp.basename(a).replace(".png", ".flo")), f)
                written += 1
    return written
