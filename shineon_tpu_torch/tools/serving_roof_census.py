"""Serving conv roof census: every census conv shape timed in isolation
(counterpart of tools/serving_roof_census.py).

    python3 -m shineon_tpu_torch.tools.flop_census --int8 --json census_int8.json
    python3 -m shineon_tpu_torch.tools.serving_roof_census --census census_int8.json \\
        [--min_tflop 0.01] [--iters 10] [--device cpu]

It reads the per-shape census of ``tools/flop_census.py`` and times each
shape above ``--min_tflop`` TFLOP a forward on the card, in turns:

  bf16  cuDNN's bf16 conv, the route of a conv outside the hand kernels
        (``networks/layers.py::conv2d_nhwc``: ``F.conv2d`` on channels_last)
  i8    the port's int8 call, ``ops/int8_conv.py::conv3x3_int8`` with the
        weight's cached slice images, the abs-max and the quantize pass
        included; beside it kernel 4 (``conv_wgmma``) alone. 3x3 shapes
        only: the others have no int8 route (``i8_ms`` null)

each by its device time in a torch.profiler trace (marked calls,
tools.device_times) and by the JAX tool's slope: a chained loop (each
call's input moved by the running sum of the outputs times 1e-20), the
slope between a window of 5 x ``iters`` calls and one of 20 x ``iters``,
median of 3, to a synchronize.

From the device times, as the JAX tool: ``conv_roof_ms_per_forward`` (the
sum of count x the time of the formulation the graph runs: i8 for ``[i8]``
entries, bf16 else), ``conv_roof_ms_best_dispatch`` (count x the faster)
and ``clip_conv_roof_ms`` (5 forwards). ``misgated``, for the convs a
resblock or the generator's ends run (routes int8 conv and cudnn): the
clip's gate, ``networks/sams/spade.py::int8_conv_profitable``, against the
faster formulation (null for the chains' convs, which the gate does not
route, and for shapes without an int8 route). Per route, the sum of count
x time over the clip's forwards against that route's device time a clip
in a trace of marked clips (the census's batch and graph,
``serving.build_inference``; tools.device_times), and the device's busy
time a clip, with the part no route's kernels take.

Prints one JSON line a shape and a summary line with the card's nvidia-smi
line. Runs on the card; ``--device cpu`` runs it on the CPU (host times
only, no trace: not device metrics).
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch

from shineon_tpu_torch.networks.layers import conv2d_nhwc
from shineon_tpu_torch.networks.sams.spade import int8_conv_profitable
from shineon_tpu_torch.ops.int8_conv import conv3x3_int8, quantize_weight
from shineon_tpu_torch.tools import card_line, device_or_exit, device_times, sync
from shineon_tpu_torch.tools.flop_census import (
    ROUTE_CHAIN,
    ROUTE_CHAIN_INT8,
    ROUTE_CUDNN,
    ROUTE_INT8_CONV,
)

# the JAX roof census's (tools/serving_roof_census.py:49-51)
SHAPE_RE = re.compile(r"conv (\d+)x(\d+)x(\d+)x(\d+) -> (\d+)x(\d+)x(\d+)x(\d+) \[(\w+)\]")
GATED_ROUTES = (ROUTE_INT8_CONV, ROUTE_CUDNN)
# device-kernel names of each route in a traced clip (the hand kernels'
# csrc names; cuDNN's convolution kernels and its layout transforms)
ROUTE_KERNELS = {
    ROUTE_CHAIN: ("chain_kernel_bf16",),
    ROUTE_CHAIN_INT8: ("chain_kernel_q", "hidden_absmax"),
    ROUTE_INT8_CONV: ("conv_wgmma", "quantize_kernel"),
    ROUTE_CUDNN: ("fprop", "cudnn", "xmma", "convolve", "conv2d", "Nhwc", "nhwc"),
}
DEVICE_REPS = 5
TRACE_CLIPS = 3


def parse_shape(key: str) -> Optional[tuple]:
    """(kh, kw, cin, cout, B, H, W, C, dtype) of a census key, or None."""
    m = SHAPE_RE.match(key)
    return None if m is None else (*(int(g) for g in m.groups()[:-1]), m.groups()[-1])


def shape_operands(kh, kw, cin, cout, B, H, W, device, seed: int = 0) -> tuple:
    """A conv's seeded operands, as the JAX tool's: (x (B, H, W, Cin) bf16,
    weight (Cout, Cin, kh, kw) f32 scaled by 0.3 / sqrt(kh kw Cin), zero
    bias)."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, H, W, cin, generator=g, device=device).to(torch.bfloat16)
    k = torch.randn(cout, cin, kh, kw, generator=g, device=device) * (0.3 / (kh * kw * cin) ** 0.5)
    return x, k, torch.zeros(cout, device=device)


def shape_calls(x, k, bias) -> Dict[str, Callable]:
    """The formulations of the conv of ``k`` and ``bias``, each a function
    of x: "bf16" (cuDNN) and, for a 3x3 conv, "i8" (the int8 call)."""
    calls = {"bf16": lambda v: conv2d_nhwc(v, k, bias, torch.bfloat16, padding=k.shape[-1] // 2)}
    if tuple(k.shape[-2:]) == (3, 3):
        qw = quantize_weight(k)
        calls["i8"] = lambda v: conv3x3_int8(v, qw, bias, torch.bfloat16)
    return calls


@torch.no_grad()
def slope_ms(fn, x, iters: int, device, repeats: int = 3) -> float:
    """The JAX tool's timing: ms a call, the slope between chained windows
    of 5 x ``iters`` and 20 x ``iters`` calls, median of ``repeats``."""

    def window(n):
        sync(device)
        t0 = time.perf_counter()
        v, acc = x, torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n):
            acc = acc + fn(v).sum(dtype=torch.float32)
            v = x + (acc * 1e-20).to(x.dtype)
        sync(device)
        float(acc)
        return time.perf_counter() - t0

    window(1)
    n_short, n_long = 5 * iters, 20 * iters
    diffs = [max(window(n_long) - window(n_short), 1e-9) / (n_long - n_short)
             for _ in range(repeats)]
    return statistics.median(diffs) * 1e3


def card_timer(device, iters: int = 10, repeats: int = 3):
    """The timer of :func:`roof_rows` on ``device``: device ms from traces
    (on the card) and the slope, of each formulation."""
    device = torch.device(device)

    def timer(kh, kw, cin, cout, B, H, W) -> dict:
        t = {}
        x, k, bias = shape_operands(kh, kw, cin, cout, B, H, W, device)
        for name, fn in shape_calls(x, k, bias).items():
            t[f"{name}_slope_ms"] = slope_ms(fn, x, iters, device, repeats)
            if device.type == "cuda":
                groups = {"all": None, "conv": ("conv_wgmma",)} if name == "i8" else {"all": None}
                with torch.no_grad():
                    d = device_times(lambda: fn(x), groups, DEVICE_REPS)
                t[f"{name}_ms"] = d["all"]
                if name == "i8":
                    t["i8_conv_ms"] = d["conv"]
            else:
                t[f"{name}_ms"] = t[f"{name}_slope_ms"]
        return t

    return timer


def roof_rows(census: dict, timer, min_tflop: float = 0.01) -> List[dict]:
    """One row a census entry of at least ``min_tflop`` TFLOP a forward:
    its times from ``timer(kh, kw, cin, cout, B, H, W)`` (a dict with
    "bf16_ms" and, for a 3x3 conv, "i8_ms"), the time of the formulation
    the graph runs, and ``misgated`` (module docstring)."""
    rows = []
    for entry in census["convs"]:
        if entry["flops"] < min_tflop * 1e12:
            continue
        parsed = parse_shape(entry["shape"])
        if parsed is None:
            raise ValueError(f"unparseable census key {entry['shape']!r}")
        kh, kw, cin, cout, B, H, W, _, dtype = parsed
        t = timer(kh, kw, cin, cout, B, H, W)
        t_bf16, t_i8 = t["bf16_ms"], t.get("i8_ms")
        graph_ms = t_i8 if dtype == "i8" else t_bf16
        best_ms = t_bf16 if t_i8 is None else min(t_bf16, t_i8)
        route = entry.get("route", ROUTE_CUDNN)
        gate = int8_conv_profitable(kh, cin, cout)
        misgated = None if route not in GATED_ROUTES or t_i8 is None else (
            gate != (t_i8 <= t_bf16))
        n = entry["count"]
        rows.append({"shape": entry["shape"], "count": n, "route": route,
                     "bf16_ms": t_bf16, "i8_ms": t_i8, "i8_conv_ms": t.get("i8_conv_ms"),
                     "bf16_slope_ms": t.get("bf16_slope_ms"), "i8_slope_ms": t.get("i8_slope_ms"),
                     "graph_ms_total": n * graph_ms, "best_ms_total": n * best_ms,
                     "tops_graph": entry["flops"] / n / (graph_ms * 1e-3) / 1e12,
                     "gate_int8": gate, "misgated": misgated})
    return rows


def roof_summary(rows: List[dict], n_frames: int, traced: Optional[dict] = None) -> dict:
    """The JAX tool's summary fields, and per route the isolated sum over a
    clip's ``n_frames`` forwards beside ``traced`` ({"busy_ms", "wall_ms",
    "routes": {route: device ms}, "other_ms"} a clip) where given."""
    per_fwd = sum(r["graph_ms_total"] for r in rows)
    by_route = defaultdict(float)
    for r in rows:
        by_route[r["route"]] += n_frames * r["graph_ms_total"]
    out = {"conv_roof_ms_per_forward": per_fwd,
           "conv_roof_ms_best_dispatch": sum(r["best_ms_total"] for r in rows),
           "clip_conv_roof_ms": n_frames * per_fwd,
           "misgated": [r["shape"] for r in rows if r["misgated"]],
           "routes": {route: {"isolated_clip_ms": ms} for route, ms in by_route.items()}}
    if traced is not None:
        for route, ms in traced["routes"].items():
            out["routes"].setdefault(route, {"isolated_clip_ms": 0.0})["traced_clip_ms"] = ms
        out.update(clip_busy_ms=traced["busy_ms"], clip_traced_ms=traced["wall_ms"],
                   clip_other_ms=traced["other_ms"])
    return out


def traced_clip(one_clip, raw, routes) -> dict:
    """The device time a clip of each route in ``routes`` (its kernels,
    ROUTE_KERNELS), the device's busy ms a clip, the rest of it (other
    kernels) and the host ms a clip of the traced window: marked clips of
    one trace (tools.device_times, the last TRACE_CLIPS of 2 x
    TRACE_CLIPS)."""
    with torch.no_grad():
        t = device_times(lambda: one_clip(raw),
                         {"busy": None, **{r: ROUTE_KERNELS[r] for r in routes}},
                         reps=TRACE_CLIPS, extra=TRACE_CLIPS)
    times = {r: t[r] for r in routes}
    return {"busy_ms": t["busy"], "wall_ms": t["wall"], "routes": times,
            "other_ms": t["busy"] - sum(times.values())}


def run(census: dict, device="cuda", min_tflop: float = 0.01, iters: int = 10,
        repeats: int = 3, clip=None) -> tuple:
    """Time the census's shapes and, on the card, trace a clip of the
    census's batch and graph (``clip``: (one_clip, raw) to reuse, else
    built by serving.build_inference). Returns (rows, summary)."""
    from shineon_tpu_torch.serving import build_inference

    device = torch.device(device)
    rows = roof_rows(census, card_timer(device, iters, repeats), min_tflop)
    traced = None
    if device.type == "cuda":
        if clip is None:
            one_clip, _, _, raw, _ = build_inference(census["batch"], device,
                                                     int8_spade=census["int8"])
        else:
            one_clip, raw = clip
        routes = sorted({c.get("route", ROUTE_CUDNN) for c in census["convs"]})
        traced = traced_clip(one_clip, raw, routes)
    summary = roof_summary(rows, census["n_frames"], traced)
    summary.update(batch=census["batch"], int8=census["int8"], min_tflop=min_tflop,
                   device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                           else "cpu"),
                   card=card_line() if device.type == "cuda" else None,
                   mode="int8" if census["int8"] else "bf16")
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--census", required=True, help="flop_census.py --json output")
    ap.add_argument("--min_tflop", type=float, default=0.01,
                    help="skip shapes below this total TFLOP a forward")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = device_or_exit(args.device, "serving_roof_census")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    with open(args.census) as f:
        census = json.load(f)
    rows, summary = run(census, device, args.min_tflop, args.iters)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
