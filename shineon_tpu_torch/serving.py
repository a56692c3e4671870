"""The serving clip: device preprocessing -> GMM TPS grid -> border
grid-sample cloth warp -> 5-frame autoregressive SAMS generation with flow
compositing (counterpart of bench.py::build_inference).

    one_clip, warp, sams, raw, n_frames = build_inference(batch_size=4)
    frames = one_clip(raw)  # (B, N, H, W, 3)

``build_inference(4, int8_spade=True)`` serves the int8 clip, as
bench.py's clip runs under ``SHINEON_INT8_SPADE=1``: quantized SPADE chains
and int8 resblock convs at eval (the warm-up rollouts train in full
precision).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from shineon_tpu_torch import tracing
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.models.warp_model import WarpModel
from shineon_tpu_torch.ops import grid_sample
from shineon_tpu_torch.options import sams_options, warp_options

WARMUP_ROLLOUTS = 3


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device that is not there raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU explicitly"
        )
    return device


def synthetic_raw_batch(opt, batch: int, seed: int = 0, device="cpu") -> Dict[str, torch.Tensor]:
    """A raw batch in the VVT n-frames layout, drawn with numpy from
    ``seed`` in the same order as the JAX package's ``_raw_batch``; then,
    when the options ask for them, COCO keypoints (``cocopose`` person
    inputs: x, y uniform over the frame, confidence in [0, 1)) and the
    GMM's grid image (``model="warp"``)."""
    rng = np.random.RandomState(seed)
    H, W, N = opt.fine_height, opt.fine_width, opt.n_frames_total

    def u8(*shape):
        return rng.randint(0, 255, shape).astype(np.uint8)

    raw = {
        "image_u8": u8(batch, N, H, W, 3),
        "prev_image_u8": u8(batch, N, H, W, 3),
        "prev_image_valid": np.ones((batch, N), np.float32),
        "cloth_u8": u8(batch, N, H, W, 3),
        "parse_u8": rng.randint(0, 20, (batch, N, H, W)).astype(np.uint8),
        "densepose_u8": u8(batch, N, H, W, 3),
        "densepose_valid": np.ones((batch, N), np.float32),
        "flow_raw": rng.randn(batch, N, H, W, 2).astype(np.float32),
        "flow_valid": np.ones((batch, N), np.float32),
    }
    if "cocopose" in opt.person_inputs:
        scale = np.array([W, H, 1.0], np.float32)
        raw["cocopose_kp"] = (rng.rand(batch, N, 18, 3) * scale).astype(np.float32)
    if opt.model == "warp":
        raw["grid_vis_u8"] = u8(batch, N, H, W, 3)
    return {k: torch.from_numpy(v).to(device) for k, v in raw.items()}


# The clip's stages, in the order one_clip runs them; the stage timing tool
# (tools/serving_stages.py) times each on its own.

def gmm_warp(warp: WarpModel, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The GMM's TPS grid from the last frame's person (agnostic, densepose)
    and cloth, and that cloth warped by it (border padding): (B, H, W, 3)."""
    person = torch.cat([feats["agnostic"][:, -1], feats["densepose"][:, -1]], dim=-1)
    cloth_in = feats["cloth"][:, -1]
    grid, _ = warp.gmm(person, cloth_in, train=False)
    return grid_sample(cloth_in, grid, padding_mode="border")


def with_warped_cloth(feats: Dict[str, torch.Tensor], warped: torch.Tensor):
    """The features with the last frame's cloth replaced by ``warped``."""
    cloth = feats["cloth"].clone()
    cloth[:, -1] = warped
    return {**feats, "cloth": cloth}


def frame_inputs(sams: SamsModel, feats: Dict[str, torch.Tensor]):
    """One generator call's eval inputs as the clip loop builds them
    (SamsModel.loop_inputs) for its last frame, with the previous-frame
    window still zero: (window, prev_maps, current_maps) in the compute
    dtype."""
    window, frame_maps = sams.loop_inputs(feats, train=False)
    return (window, *frame_maps(sams.n_frames_total - 1))


def gen_frame(sams: SamsModel, window, prev_maps, current_maps) -> torch.Tensor:
    """One generator forward in eval mode, the clip loop's body."""
    return sams.frame(window, prev_maps, current_maps, train=False)


def gen_scan(sams: SamsModel, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The eval clip loop: every frame (B, N, H, W, 3)."""
    with tracing.span("serving.gen_scan"):
        return sams.generate_n_frames(feats, train=False)[2]


def make_one_clip(warp: WarpModel, sams: SamsModel):
    """The clip function: raw batch -> all generated frames (B, N, H, W, 3).
    Each call is a request of the port's spans (shineon_tpu_torch/tracing.py),
    its stages spans inside it."""

    @torch.no_grad()
    def one_clip(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with tracing.request():
            with tracing.span("serving.features"):
                feats = sams.features(batch)
            with tracing.span("serving.gmm_warp"):
                feats = with_warped_cloth(feats, gmm_warp(warp, feats))
            return gen_scan(sams, feats)

    return one_clip


@torch.no_grad()
def warm_up(sams: SamsModel, batch: Dict[str, torch.Tensor], rollouts: int = WARMUP_ROLLOUTS):
    """Train-mode rollouts that update the generator's running statistics
    and spectral ``u``: at random init the running stats are meaningless and
    the bf16 eval clip overflows without them (bench.py:189-204). With
    trained weights this is a no-op. A set-up span, ``setup.warm_up``."""
    with tracing.setup("setup.warm_up"):
        feats = sams.features(batch)
        for _ in range(rollouts):
            sams.generate_n_frames(feats, train=True)


def build_models(batch_size: int, device="cuda", seed: int = 420, **overrides):
    """The serving clip's models at the production options (``overrides``
    replace any of them, e.g. a smaller fine size or depth, ``int8_spade=True``
    or attention placements), with weights drawn from ``torch.Generator``
    seeds (``seed`` for SAMS, ``seed + 1`` for the GMM) by the JAX package's
    init rules, and a raw batch; not yet warmed. Runs on the card unless
    ``device`` says otherwise. Returns (warp, sams, raw_batch)."""
    device = resolve_device(device)
    sams_opt = sams_options(**{"batch_size": batch_size, "is_train": False, **overrides})
    warp_opt = warp_options(batch_size=batch_size, **overrides)
    sams = SamsModel(sams_opt, device)
    warp = WarpModel(warp_opt, device)
    sams.init_weights(torch.Generator().manual_seed(seed))
    warp.init_weights(torch.Generator().manual_seed(seed + 1))
    return warp, sams, synthetic_raw_batch(sams_opt, batch_size, device=device)


def build_inference(batch_size: int, device="cuda", seed: int = 420, **overrides):
    """Build the serving clip (arguments as :func:`build_models`) and warm
    its running statistics. Returns (one_clip, warp, sams, raw_batch,
    n_frames)."""
    warp, sams, raw = build_models(batch_size, device, seed, **overrides)
    warm_up(sams, raw)
    return make_one_clip(warp, sams), warp, sams, raw, sams.n_frames_total
