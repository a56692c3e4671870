"""The int8 3x3 conv probe on the card (counterpart of
tools/pallas_conv_probe.py): each of the TPU tool's seven variants at its
four full-resolution serving shapes (batch 16), checked, then timed.

    python -m shineon_tpu_torch.tools.conv_probe [--variant mmonly] [--only 0] [--iters 10]

On this card five of the variants are one function. merged, taps9,
shifted3, rolledcat and rolled9 differ only in how the TPU kernel lays out
the nine taps for Mosaic (one K = 9 Cin product, three K = 3 Cin ones, rolls
on the fused row dim, ...); all compute the int8 conv, and all run the
port's one int8 conv kernel (``ops/int8_conv.py::conv3x3_int8``, kernel 4).
The two diagnostic variants compute other functions and run their own
kernels (``ops/probes.py``): ``mmonly`` multiplies the centre tap by all
nine weight taps (the int8 product rate with no relayout), ``taps9bf16``
takes the nine taps as bf16 operands with f32 sums. Each variant is checked
against the port's plain int8 conv (``conv3x3_int8_plain``), except mmonly,
which is checked against its own plain version; a mismatch skips the
timing and fails the run. All four shapes run (the TPU tool skips Cin = 64,
a Mosaic limit). Its row-tile option (``--th``) has no counterpart: the
kernels tile for this card. For mmonly and taps9bf16 the tool also times
kernel 4 at the same shape, so the three rates print side by side.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from shineon_tpu_torch.ops import int8_conv, probes
from shineon_tpu_torch.ops.fused_spade import error_ratio

VARIANTS = ("merged", "taps9", "mmonly", "taps9bf16", "rolledcat", "rolled9", "shifted3")
DIAGNOSTIC = {"mmonly": probes.conv_mmonly, "taps9bf16": probes.conv_taps9bf16}
SHAPES = (
    # (B, H, W, Cin, Cout): the TPU tool's full-resolution serving rows
    (16, 256, 192, 128, 256),
    (16, 256, 192, 128, 128),
    (16, 256, 192, 64, 128),
    (16, 256, 192, 128, 64),
)


def conv_inputs(shape, device, seed=0):
    """v (B, H, W, Cin) bf16, the conv's OIHW weight (* 0.05) and bias
    (* 0.1), normal from a seed."""
    B, H, W, cin, cout = shape
    g = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn((B, H, W, cin), generator=g, device=device).to(torch.bfloat16)
    w = 0.05 * torch.randn((cout, cin, 3, 3), generator=g, device=device)
    bias = 0.1 * torch.randn((cout,), generator=g, device=device)
    return v, w, bias


def variant_call(variant, v, qw, bias):
    """(the variant's call, its plain version's result) on v, the quantized
    weight qw and bias: the input quantized as the TPU tool quantizes it
    outside its kernel."""
    if variant not in DIAGNOSTIC:
        ref = int8_conv.conv3x3_int8_plain(v, qw, bias, torch.bfloat16)
        return (lambda: int8_conv.conv3x3_int8(v, qw, bias, torch.bfloat16)), ref
    xp, s = probes.quantize_padded(v)
    qw = probes.with_tap_images(qw)  # once, outside the timed call
    scale = (s * qw.scale).contiguous()
    if variant == "mmonly":
        ref = probes.conv_mmonly_plain(xp, qw, scale, bias)
    else:
        ref = int8_conv.conv3x3_int8_plain(v, qw, bias, torch.bfloat16)
    return (lambda: DIAGNOSTIC[variant](xp, qw, scale, bias)), ref


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def run_variant(variant: str, shape, device, iters: int) -> dict:
    """Check one variant at one shape and, with ``iters`` > 0 (on the card
    only), time it. Returns what it printed, as a dict."""
    B, H, W, cin, cout = shape
    if iters and torch.device(device).type != "cuda":
        raise ValueError("conv_probe: timing needs a CUDA device")
    v, w, bias = conv_inputs(shape, device)
    qw = int8_conv.quantize_weight(w)
    call, ref = variant_call(variant, v, qw, bias)
    out = call()
    tol = int8_conv.INT8_CONV_TOLERANCE[torch.bfloat16]
    ratio = error_ratio(out, ref)
    ok = (tuple(out.shape) == (B, H, W, cout) and bool(torch.isfinite(out.float()).all())
          and ratio <= tol)
    result = dict(variant=variant, shape=shape, ok=ok, ratio=ratio,
                  max_abs_err=(out.float() - ref.float()).abs().max().item())
    line = (f"  {cin}->{cout}: max|d|={result['max_abs_err']:.3e} "
            f"max|d|/(|ref|+rms)={ratio:.3e} (limit {tol:g})")
    if not ok:
        print(line + " MISMATCH, not timed", flush=True)
        return result
    if iters:
        ops = 2.0 * 9 * B * H * W * cin * cout
        result["ms"] = cuda_ms(call, iters)
        line += (f" | conv 3x3x{cin}x{cout} @ {B}x{H}x{W}: {variant} {result['ms']:.4f} ms "
                 f"({ops / result['ms'] / 1e9:.1f} Tops/s)")
        if variant in DIAGNOSTIC:
            result["kernel4_ms"] = cuda_ms(
                lambda: int8_conv.conv3x3_int8(v, qw, bias, torch.bfloat16), iters)
            line += (f" | int8 conv kernel {result['kernel4_ms']:.4f} ms "
                     f"({ops / result['kernel4_ms'] / 1e9:.1f} Tops/s)")
    print(line, flush=True)
    return result


def main(argv=None, device="cuda") -> int:
    """Run one variant at the shapes chosen; 0 if every check passes."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", default="merged", choices=VARIANTS)
    ap.add_argument("--only", type=int, default=None, choices=range(len(SHAPES)),
                    help="probe only SHAPES[i]")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a shape (0: check only)")
    args = ap.parse_args(argv)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("conv_probe: no CUDA device", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else device
    print(f"device={name} variant={args.variant}", flush=True)
    shapes = SHAPES if args.only is None else [SHAPES[args.only]]
    t0 = time.perf_counter()
    results = [run_variant(args.variant, shape, device, args.iters) for shape in shapes]
    print(f"{sum(r['ok'] for r in results)} of {len(results)} shapes agree "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
