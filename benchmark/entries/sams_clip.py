"""Entry of the SAMS serving clip: builds the system under test
(``shineon_tpu_torch.serving``'s clip at a configuration's options, with the
benchmark's weights), and judges its frames against the plain reference.

The numbers compared (limits in the configuration's ``checks``):

* ``frame_rel_rms``: over the sampled hand-ins, every clip of each batch (one
  user's) and its frames, the largest rms(served - reference) /
  rms(reference - shared), where each reference
  frame is computed from the served frames before it (the served loop's own
  feedback), and ``shared`` is the part of the frame that the flow warp
  carries over from the previous frame (the warped previous frame times 1 -
  mask), which both sides take from the same served frame. The denominator
  is what the generator itself contributes to the frame.
* ``nonfinite``: served values that are not finite (limit 0).
"""

from __future__ import annotations

import gc
import math
from typing import Dict, List, Optional

import torch

from benchmark.reference import sams_clip as ref
from benchmark.traffic import Traffic
from benchmark.weights import draw

# the served model's option keys that the warp stage (the GMM) takes as well
_WARP_KEYS = ("fine_height", "fine_width", "grid_size", "ngf", "precision", "n_frames_total",
              "cloth_inputs")


class Served:
    """The system under test, built and warmed: ``one_clip(raw)`` is the
    timed call; ``traffic`` its inputs; ``weights`` what both sides load."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        from shineon_tpu_torch import serving
        from shineon_tpu_torch.models.sams_model import SamsModel
        from shineon_tpu_torch.models.warp_model import WarpModel
        from shineon_tpu_torch.options import sams_options, warp_options

        options = self.opt = cfg["options"]
        B = mix["batch"]
        gen_specs, gmm_specs = ref.generator_specs(self.opt), ref.gmm_specs(self.opt)
        self.weights = {**draw(gen_specs, cfg["init"]["generator"], seed, device),
                        **draw(gmm_specs, cfg["init"]["gmm"], seed + 1, device)}
        self.traffic = Traffic(mix, self.opt, seed, device)
        sams = SamsModel(sams_options(batch_size=B, is_train=False, **options), device)
        warp = WarpModel(warp_options(batch_size=B, **{k: options[k] for k in _WARP_KEYS}), device)
        sams.generator.load_state_dict({n: self.weights[n] for n, _, _ in gen_specs}, strict=True)
        warp.gmm.load_state_dict({n: self.weights[n] for n, _, _ in gmm_specs}, strict=True)
        serving.warm_up(sams, self.traffic.hand_in(0))
        self.models = (sams, warp)
        self.one_clip = serving.make_one_clip(warp, sams)

    def free(self):
        """Drop the program's state (models and the clip), keeping the
        weights and the traffic for the reference."""
        self.models = self.one_clip = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def build(cfg: dict, mix: dict, seed: int, device) -> Served:
    return Served(cfg, mix, seed, device)


def frame_errors(served: torch.Tensor, reference: torch.Tensor, shared: torch.Tensor) -> List[float]:
    """For each frame, the largest over the batch's clips of
    rms(served - reference) / rms(reference - shared)."""
    out = []
    for t in range(served.shape[1]):
        s, r, c = served[:, t].double(), reference[:, t].double(), shared[:, t].double()
        num = (s - r).square().flatten(1).mean(1).sqrt()
        den = (r - c).square().flatten(1).mean(1).sqrt()
        ratio = torch.where(den > 0, num / den, torch.full_like(num, math.inf))
        out.append(float(ratio.max()))
    return out


def judge(served: Dict[int, torch.Tensor], traffic: Traffic, weights, opt: dict,
          bits: Optional[int]) -> Dict[str, float]:
    """The numbers compared for ``served`` ({hand-in: frames}): see the
    module docstring. ``bits`` the reference's quantization (None: float)."""
    worst, nonfinite, per_clip, per_frame = 0.0, 0, {}, []
    with ref.plain_precision(), torch.no_grad():
        state = ref.warm_up(weights, ref.features(traffic.hand_in(0), opt), opt)
        for i in sorted(served):
            frames = served[i]
            clean = torch.nan_to_num(frames.float(), nan=0.0, posinf=0.0, neginf=0.0)
            expect, shared = ref.clip_frames(weights, state, traffic.hand_in(i), opt, served=clean,
                                             bits=bits)
            errs = [e if math.isfinite(e) else math.inf for e in frame_errors(frames, expect, shared)]
            bad = int((~torch.isfinite(frames.float())).sum())
            per_clip[i] = math.inf if bad else max(errs)
            per_frame = [max(a, b) for a, b in zip(per_frame, errs)] if per_frame else errs
            worst = max(worst, per_clip[i])
            nonfinite += bad
    return {"frame_rel_rms": worst, "nonfinite": float(nonfinite), "per_clip": per_clip,
            "per_frame": per_frame}


def counters() -> Dict[str, int]:
    """The port's launch counters of its hand-written serving kernels."""
    from shineon_tpu_torch.ops import fused_spade, int8_conv

    fmm = fused_spade.fused_multispade_modulate
    return {"chain": fmm.launches, "chain_int8": fmm.int8_launches,
            "chain_prepass": fmm.absmax_launches, "int8_conv": int8_conv.conv3x3_int8.launches,
            "int8_quantize": int8_conv.quantize_int8.launches}


def check(cfg: dict, served: Dict[int, torch.Tensor], traffic: Traffic, weights) -> Dict[str, float]:
    """The numbers compared for a run's sampled clips, against the
    reference at the configuration's serving precision."""
    opt = cfg["options"]
    return judge(served, traffic, weights, opt, 8 if opt.get("int8_spade") else None)
