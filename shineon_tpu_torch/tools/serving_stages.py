"""Stage timing of the serving clip (counterpart of
tools/profile_serving_stages.py).

    python3 -m shineon_tpu_torch.tools.serving_stages [--batch 16] [--iters 20]
        [--int8] [--attention] [--device cpu]

Stages, the functions of ``serving.py`` that ``one_clip`` is composed of:

  features   device preprocessing (uint8 decode, normalize, label maps)
  gmm_warp   the GMM, its TPS grid and the cloth's border grid-sample
  gen_frame  one generator forward at the clip loop's eval inputs
  gen_scan   ``generate_n_frames(train=False)``, the 5-frame loop
  one_clip   the whole clip

Protocol, the JAX tool's: each stage runs in a chained loop of calls in
which every call's input depends on the previous call's output (the mean
of every output leaf times 1e-12, added on the device, no host sync); a
window of calls ends in one synchronize and a fetch. A call's time is the
slope between a window of ``iters`` calls and one four times longer,
median of 3 (``half`` = max(iters // 2, 5) calls for gen_scan and
one_clip). Derived, as there: ``scan_minus_5xframe_ms`` (the loop's flow
compositing, window carry and stacking), ``clip_minus_stages_ms`` (the
pipeline glue) and ``clip_fps``.

The JAX tool meant these times to be device time; on a host-bound card the
wall slope is not. So each stage is also traced with torch.profiler
(device activity only; 2 x TRACE_CALLS chained calls, each marked, the
last TRACE_CALLS counted): ``<stage>_busy_ms``, the device's busy time a
call, and ``<stage>_idle``, the share of the untraced slope ``<stage>_ms``
in which the device was idle. The profiler's own cost a launch stretches
the traced window: ``<stage>_traced_ms`` is the host time a call there,
and ``<stage>_traced_idle`` the idle share of that, which reads higher.
``<stage>_launches``: the launches of each serving kernel in one call,
from the wrappers' counters.

Prints one JSON line: the JAX tool's fields, these, the mode (bf16 or
int8, +attention), the batch, the device's name and the card's nvidia-smi
line. Runs on the card; ``--device cpu`` runs on the CPU (host times, no
trace: CPU numbers are not device metrics).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import time
from typing import Dict

import torch

from shineon_tpu_torch.options import ATTENTION_PLACEMENT
from shineon_tpu_torch.serving import (
    build_inference,
    frame_inputs,
    gen_frame,
    gen_scan,
    gmm_warp,
    make_one_clip,
    with_warped_cloth,
)
from shineon_tpu_torch.tools import card_line, device_or_exit, device_times, launch_counts, sync

SERVING_BATCH = 16  # bench.py's serving batch (bench.BATCH)
STAGES = ("features", "gmm_warp", "gen_frame", "gen_scan", "one_clip")
LONG_STAGES = ("gen_scan", "one_clip")  # timed over `half` calls
TRACE_CALLS = 3
REPEATS = 3


def tree_mean(out) -> torch.Tensor:
    """An f32 0-d tensor on the device that depends on every leaf of ``out``
    (a tensor or a dict of tensors): the sum of their means."""
    leaves = out.values() if isinstance(out, dict) else (out,)
    return sum(leaf.float().mean() for leaf in leaves)


def bumped(t: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``t + acc * 1e-12`` in t's dtype, on the device."""
    return t + (acc * 1e-12).to(t.dtype)


def bumped_flow(raw: Dict[str, torch.Tensor], acc: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The raw batch with its ``flow_raw`` bumped by ``acc``: the chain of
    the features and one_clip stages, and of the bench's clips."""
    return {**raw, "flow_raw": bumped(raw["flow_raw"], acc)}


def clip_mode(sams, int8: bool, attention: bool) -> str:
    """The clip's mode: int8, else its compute dtype (bf16 or f32), with
    "+attention" when it has attention blocks."""
    mode = "int8" if int8 else "bf16" if sams.compute_dtype == torch.bfloat16 else "f32"
    return mode + ("+attention" if attention else "")


def build_stages(warp, sams, raw) -> Dict[str, tuple]:
    """Each stage as (call, first input, perturb(input, acc) -> next input),
    the JAX tool's chains: features and one_clip perturb the raw flow,
    gmm_warp the last frame's cloth, gen_frame the previous-frame window,
    gen_scan the features' flow."""
    with torch.no_grad():
        feats = sams.features(raw)
    window, prev_maps, current_maps = frame_inputs(sams, feats)
    return {
        "features": (sams.features, raw, bumped_flow),
        "gmm_warp": (lambda f: gmm_warp(warp, f), feats,
                     lambda f, acc: {**f, "cloth": bumped(f["cloth"][:, -1:], acc)}),
        "gen_frame": (lambda w: gen_frame(sams, w, prev_maps, current_maps), window, bumped),
        "gen_scan": (lambda f: gen_scan(sams, f), feats,
                     lambda f, acc: {**f, "flow": bumped(f["flow"], acc)}),
        "one_clip": (make_one_clip(warp, sams), raw, bumped_flow),
    }


def compose_stages(stages: Dict[str, tuple]) -> torch.Tensor:
    """The clip as the timed stages (build_stages) give it one after
    another from the raw batch: features, gmm_warp, the warped cloth into
    the features, gen_scan."""
    with torch.no_grad():
        feats = stages["features"][0](stages["features"][1])
        warped = stages["gmm_warp"][0](feats)
        return stages["gen_scan"][0](with_warped_cloth(feats, warped))


@torch.no_grad()
def chained(stage, n: int, device) -> torch.Tensor:
    """``n`` calls of ``stage``, each input perturbed by the previous call's
    output; the last call's ``tree_mean`` (not waited for)."""
    call, x0, perturb = stage
    acc = torch.zeros((), dtype=torch.float32, device=device)
    for _ in range(n):
        acc = tree_mean(call(perturb(x0, acc)))
    return acc


def window_s(stage, n: int, device) -> float:
    """Host seconds of a window of ``n`` chained calls, to a synchronize and
    a fetch of the last mean, which must be finite."""
    sync(device)
    t0 = time.perf_counter()
    acc = chained(stage, n, device)
    sync(device)
    value = float(acc)
    seconds = time.perf_counter() - t0
    if not math.isfinite(value):
        raise RuntimeError(f"a chained stage gave {value}")
    return seconds


def slope_s(stage, iters: int, device, repeats: int = REPEATS) -> float:
    """Seconds a call: the slope between a window of ``iters`` calls and
    one of 4 * ``iters``, median of ``repeats`` pairs."""
    diffs = []
    for _ in range(repeats):
        short = window_s(stage, iters, device)
        long = window_s(stage, 4 * iters, device)
        diffs.append(max(long - short, 1e-9) / (3 * iters))
    return statistics.median(diffs)


def busy_ms(stage, device) -> tuple:
    """The device's busy ms a call of ``stage`` in a trace of chained calls
    (tools.device_times: the last TRACE_CALLS marked calls after as many
    others), the host ms a call of the traced window, and each kernel's
    device ms and launches a call there (tools.op_means)."""
    acc = [torch.zeros((), dtype=torch.float32, device=device)]
    call, x0, perturb = stage

    @torch.no_grad()
    def one():
        acc[0] = tree_mean(call(perturb(x0, acc[0])))

    t = device_times(one, {"busy": None}, reps=TRACE_CALLS, extra=TRACE_CALLS, ops=True)
    if not math.isfinite(float(acc[0])):
        raise RuntimeError(f"a chained stage gave {float(acc[0])}")
    return t["busy"], t["wall"], t["ops"]


def stage_launches(stage, device) -> Dict[str, int]:
    """Launches of each serving kernel in one call of ``stage``."""
    before = launch_counts()
    chained(stage, 1, device)
    sync(device)
    return {k: v - before[k] for k, v in launch_counts().items()}


def measure_stages(stages: Dict[str, tuple], n_frames: int, batch: int, device,
                   iters: int = 20, repeats: int = REPEATS) -> dict:
    """The JAX tool's fields for ``stages`` (build_stages), and on the card
    each stage's busy time, idle share and launches a call."""
    device = torch.device(device)
    half = max(iters // 2, 5)
    t = {}
    for name in STAGES:
        stage = stages[name]
        t[f"{name}_launches"] = stage_launches(stage, device)  # also the warm-up call
        n = half if name in LONG_STAGES else iters
        t[f"{name}_ms"] = slope_s(stage, n, device, repeats) * 1e3
        if device.type == "cuda":
            busy, wall, _ = busy_ms(stage, device)
            t[f"{name}_busy_ms"], t[f"{name}_traced_ms"] = busy, wall
            t[f"{name}_idle"] = 1 - busy / t[f"{name}_ms"]
            t[f"{name}_traced_idle"] = 1 - busy / wall
    t["scan_minus_5xframe_ms"] = t["gen_scan_ms"] - n_frames * t["gen_frame_ms"]
    t["clip_minus_stages_ms"] = (t["one_clip_ms"] - t["features_ms"] - t["gmm_warp_ms"]
                                 - t["gen_scan_ms"])
    t["clip_fps"] = batch * n_frames / (t["one_clip_ms"] / 1e3)
    if device.type == "cuda":
        t["scan_minus_5xframe_busy_ms"] = (t["gen_scan_busy_ms"]
                                           - n_frames * t["gen_frame_busy_ms"])
        t["clip_minus_stages_busy_ms"] = (t["one_clip_busy_ms"] - t["features_busy_ms"]
                                          - t["gmm_warp_busy_ms"] - t["gen_scan_busy_ms"])
    return t


def run(batch: int = SERVING_BATCH, iters: int = 20, int8: bool = False,
        attention: bool = False, device="cuda") -> dict:
    """Build the warmed serving clip (serving.build_inference at the
    production options) and time its stages: the JSON line's fields. Runs
    on the card unless ``device`` says otherwise."""
    placement = ATTENTION_PLACEMENT if attention else {}
    _, warp, sams, raw, n_frames = build_inference(batch, device, int8_spade=int8, **placement)
    device = raw["flow_raw"].device
    t = measure_stages(build_stages(warp, sams, raw), n_frames, batch, device, iters)
    t.update(device=(torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
             card=card_line() if device.type == "cuda" else None,
             mode=clip_mode(sams, int8, attention), batch=batch, n_frames=n_frames,
             iters=iters, repeats=REPEATS)
    return t


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=SERVING_BATCH)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--int8", action="store_true", help="the int8 serving clip")
    p.add_argument("--attention", action="store_true",
                   help="attention blocks at options.ATTENTION_PLACEMENT")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = device_or_exit(args.device, "serving_stages")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(run(args.batch, args.iters, args.int8, args.attention, device)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
