"""The one traffic generator: a traffic mix is a data file of parameters
(``traffic/<name>.json``) that this module reads.

Keys of a mix:

* ``batch``: clips a hand-in (each clip one user's ``frames`` frames);
* ``pool``: distinct raw batches drawn on the device from the seed;
* ``in_flight``: batches handed in and not yet finished at most (1: each
  batch's output is awaited before the next is handed in).

Hand-in ``i`` takes pool batch ``i % pool`` offset by ``o = i // pool``:
every uint8 image plus ``o`` (wrapping at 256) and the flow plus ``o /
100``, so no two hand-ins of a window take the same inputs, and every seed
gives the same sizes in another draw.
"""

from __future__ import annotations

from typing import Dict

import torch

RGB_KEYS = ("image_u8", "prev_image_u8", "cloth_u8", "densepose_u8")


def raw_batch(opt: dict, batch: int, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """One raw batch in the served model's layout (VVT n-frames: uint8
    frames, parse labels 0-19, pixel flows N(0, 1), validity flags), drawn
    from ``g``."""
    H, W, N = opt["fine_height"], opt["fine_width"], opt["n_frames_total"]

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)

    ones = torch.ones((batch, N), device=device)
    return {
        "image_u8": u8(batch, N, H, W, 3),
        "prev_image_u8": u8(batch, N, H, W, 3),
        "prev_image_valid": ones.clone(),
        "cloth_u8": u8(batch, N, H, W, 3),
        "parse_u8": torch.randint(0, 20, (batch, N, H, W), generator=g, device=device,
                                  dtype=torch.uint8),
        "densepose_u8": u8(batch, N, H, W, 3),
        "densepose_valid": ones.clone(),
        "flow_raw": torch.randn((batch, N, H, W, 2), generator=g, device=device),
        "flow_valid": ones.clone(),
    }


class Traffic:
    """The pool of a mix and its hand-ins."""

    def __init__(self, mix: dict, opt: dict, seed: int, device):
        self.mix, self.batch, self.in_flight = mix, mix["batch"], mix["in_flight"]
        g = torch.Generator(device=device)
        g.manual_seed((seed + 7919) % 2 ** 64)
        self.pool = [raw_batch(opt, self.batch, g, device) for _ in range(mix["pool"])]

    def hand_in(self, i: int) -> Dict[str, torch.Tensor]:
        """Hand-in ``i``'s raw batch."""
        base = self.pool[i % len(self.pool)]
        o = i // len(self.pool)
        if o == 0:
            return dict(base)
        out = dict(base)
        for k in RGB_KEYS:
            out[k] = base[k] + (o % 256)
        out["flow_raw"] = base["flow_raw"] + o / 100.0
        return out
