"""Independent FLOP census of the port generator's convolutions
(counterpart of tools/flop_census.py).

    python3 -m shineon_tpu_torch.tools.flop_census [--batch 16] [--int8] [--json PATH]

It shares no arithmetic with ``bench.py::analytic_generator_flops``: it
runs one generator forward of the serving graph (``serving.gen_frame`` at
the clip loop's eval inputs) under ``torch.utils.flop_counter.FlopCounterMode``
and takes the FLOPs of every ``aten.convolution`` PyTorch dispatches, at
the shapes it dispatches them. Each conv is keyed ``"conv
KHxKWxCINxCOUT -> BxHxWxC [dtype]"``, the JAX census's key, which
``tools/serving_roof_census.py``'s ``SHAPE_RE`` parses, and carries its
route in the clip on the card: the fused chain (kernel 1), the quantized
chain (kernel 2), the int8 conv (kernel 4) or cuDNN. Matmuls are reported
apart (the spectral norms' power step, unscaled), as the JAX census
leaves ``dot_general`` out.

It counts on the CPU plain path: FlopCounterMode sees the ATen ops PyTorch
dispatches and cannot see inside a hand kernel, and on a CPU tensor each
kernel's wrapper takes its plain version, which runs the same convolutions
as ``aten.convolution`` (the int8 conv's exact integer sums in float64,
keyed ``[i8]``). So this tool has no ``--device``: it needs no card.

Size: a full-width forward at 256x192 is too slow for the CPU, so it runs
the production widths at 64x48, batch 1, and scales. Every conv of the
generator runs at one of its five levels, 1/1 to 1/16 of the frame; at
64x48 those are 64x48 .. 4x3 (64 >> 4 = 4, 48 >> 4 = 3), each exactly a
sixteenth of the pixels of 256x192's level (256x192 .. 16x12). So every
conv's FLOPs scale by exactly 16 and its key's H and W by 4; the batch
scales keys and FLOPs linearly. The scaled count is exact.

Prints the per-shape table, the total against the analytic count, and one
JSON line; exits 1 when they disagree by more than 10%, as the JAX tool
does (``--int8`` counts the int8 graph and is informational: exit 0).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from shineon_tpu_torch.bench import analytic_generator_flops
from shineon_tpu_torch.ops import fused_spade, int8_conv
from shineon_tpu_torch.tools import card_line

COUNT_SIZE = (64, 48)  # (H, W) the forward runs at
FRAME = (256, 192)  # the serving frame it is scaled to
HW_SCALE = (FRAME[0] // COUNT_SIZE[0], FRAME[1] // COUNT_SIZE[1])
SEED = 420  # the weights' (FLOPs depend on none of them)
CENSUS_BATCH = 16  # the JAX census's default batch
TOLERANCE = 0.10

ROUTE_CHAIN = "fused chain (kernel 1)"
ROUTE_CHAIN_INT8 = "int8 chain (kernel 2)"
ROUTE_INT8_CONV = "int8 conv (kernel 4)"
ROUTE_CUDNN = "cudnn"
# the plain version of each hand kernel whose convolutions run inside it on
# the card; the outermost on the call stack names the route
_ROUTES = {
    fused_spade.multispade_modulate_plain.__code__: ROUTE_CHAIN,
    fused_spade.multispade_modulate_plain_int8.__code__: ROUTE_CHAIN_INT8,
    int8_conv.conv3x3_int8_plain.__code__: ROUTE_INT8_CONV,
}
# float64 convolutions are the int8 plain versions' exact integer sums
_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
           torch.float64: "i8"}


def _route() -> str:
    route, frame = ROUTE_CUDNN, sys._getframe()
    while frame is not None:
        route = _ROUTES.get(frame.f_code, route)
        frame = frame.f_back
    return route


class _ConvLog(TorchDispatchMode):
    """Records every aten.convolution: (input, weight and output shapes,
    dtype, route)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket is torch.ops.aten.convolution:
            x, w, transposed = args[0], args[1], args[6]
            self.calls.append((tuple(x.shape), tuple(w.shape), tuple(out.shape), transposed,
                               x.dtype, _route()))
        return out


def count_convs(fn, batch_scale: int = 1, hw_scale: tuple = (1, 1)) -> dict:
    """Run ``fn()`` under FlopCounterMode; the census of its
    convolutions, FLOPs and keys scaled by ``batch_scale`` and the output's
    H and W by ``hw_scale``: {"total_flops", "convs": [{"shape", "count",
    "flops", "route"}] largest first (one entry a shape and route: a shape
    may run on two routes), "matmul_flops", "counter_flops"}.
    The last two are FlopCounterMode's own, unscaled: the matmuls are the
    spectral norms' power step, whose size depends on neither the batch nor
    the frame, and its total of every op it counts."""
    log = _ConvLog()
    with FlopCounterMode(display=False) as counter, log, torch.no_grad():
        fn()
    scale = batch_scale * hw_scale[0] * hw_scale[1]
    by_shape = defaultdict(lambda: [0, 0.0])
    total = 0.0
    for x, w, out, transposed, dtype, route in log.calls:
        fl = float(conv_flop_count(list(x), list(w), list(out), transposed)) * scale
        cout, cin_g, kh, kw = w
        b, c, ho, wo = out
        key = (f"conv {kh}x{kw}x{cin_g}x{cout} -> {b * batch_scale}x{ho * hw_scale[0]}x"
               f"{wo * hw_scale[1]}x{c} [{_DTYPES.get(dtype, str(dtype))}]")
        entry = by_shape[key, route]
        entry[0] += 1
        entry[1] += fl
        total += fl
    counts = counter.get_flop_counts()["Global"]
    conv_counted = sum(v for op, v in counts.items() if "convolution" in str(op))
    if abs(conv_counted * scale - total) > 1e-6 * max(total, 1.0):
        raise RuntimeError(f"FlopCounterMode counts {conv_counted * scale} conv FLOPs, the "
                           f"per-call log {total}")
    convs = [{"shape": k, "count": n, "flops": fl, "route": route}
             for (k, route), (n, fl) in sorted(by_shape.items(), key=lambda kv: -kv[1][1])]
    matmul = sum(v for op, v in counts.items() if "convolution" not in str(op))
    return {"total_flops": total, "convs": convs, "matmul_flops": matmul,
            "counter_flops": float(counter.get_total_flops())}


def generator_census(batch: int = CENSUS_BATCH, int8: bool = False, **overrides) -> dict:
    """The census of one serving generator forward at ``batch`` and the
    production options (``overrides`` replace any but the frame size),
    counted on the CPU at batch 1 and COUNT_SIZE and scaled to FRAME."""
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.options import sams_options
    from shineon_tpu_torch.serving import frame_inputs, gen_frame, synthetic_raw_batch

    opt = sams_options(**{"batch_size": 1, "is_train": False, "int8_spade": int8,
                          **overrides, "fine_height": COUNT_SIZE[0],
                          "fine_width": COUNT_SIZE[1]})
    sams = SamsModel(opt, "cpu")
    sams.init_weights(torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        feats = sams.features(synthetic_raw_batch(opt, 1))
    window, prev_maps, current_maps = frame_inputs(sams, feats)
    out = count_convs(lambda: gen_frame(sams, window, prev_maps, current_maps),
                      batch_scale=batch, hw_scale=HW_SCALE)
    out.update(batch=batch, int8=bool(int8), n_frames=sams.n_frames_total, frame=list(FRAME),
               counted_at=list(COUNT_SIZE))
    return out


def report(census: dict, analytic: float) -> str:
    """The JAX tool's markdown table and totals."""
    lines = [f"census of one generator forward (batch {census['batch']}, "
             f"{'int8' if census['int8'] else 'fp'} serving graph, counted at "
             f"{census['counted_at'][0]}x{census['counted_at'][1]} and scaled to "
             f"{census['frame'][0]}x{census['frame'][1]}):", "",
             "| op shape | count/forward | TFLOP | route |", "|---|---|---|---|"]
    for c in census["convs"][:20]:
        lines.append(f"| `{c['shape']}` | {c['count']} | {c['flops'] / 1e12:.3f} | "
                     f"{c['route']} |")
    lines += ["", f"- per generator forward: {census['total_flops'] / 1e12:.4f} TFLOP "
              f"(matmuls apart: {census['matmul_flops'] / 1e12:.6f} TFLOP)",
              f"- analytic count (bench.analytic_generator_flops): {analytic / 1e12:.4f} TFLOP",
              f"- ratio census/analytic: {census['total_flops'] / analytic:.4f}"]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=CENSUS_BATCH)
    ap.add_argument("--int8", action="store_true",
                    help="census the int8 serving graph (informational: the analytic count "
                    "models the fp graph)")
    ap.add_argument("--json", default=None,
                    help="write the per-shape table as JSON (serving_roof_census reads it)")
    args = ap.parse_args(argv)

    census = generator_census(args.batch, args.int8)
    analytic = analytic_generator_flops(args.batch)
    census.update(analytic_flops=analytic, ratio=census["total_flops"] / analytic,
                  mode="int8" if args.int8 else "bf16", counted_on="cpu", card=card_line())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(census, f, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)
    print(report(census, analytic))
    print(json.dumps({k: v for k, v in census.items() if k != "convs"}), flush=True)
    if args.int8:
        return 0
    ok = abs(census["ratio"] - 1.0) < TOLERANCE
    print("AGREE within 10%" if ok else "DISAGREE by >10%")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
