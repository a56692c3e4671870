#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shineon_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: torch's device name and count, and nvidia-smi's name and
     power limit;
  2. build the hand-written kernel from csrc/ and print its ptxas report;
  3. hold each kernel against its plain PyTorch version at every shape the
     serving clip gives it (the clip's batch), in bf16 and f32, plus a
     ragged tile, element by element, and time kernel and plain version on
     the same bf16 operands;
  4. check the whole clip on a small input: the kernel path on the card
     against the plain path on the CPU, same weights, f32;
  5. build the serving clip at full width (256x192, 5 frames, widths
     2^6..2^10, batch 4, bf16, random weights from a seed, warmed running
     statistics), run it once with every launch counter at 0, check the
     frames and that every kernel of the path was launched as often as the
     model has sites, then time it (median of 3 after a warm-up call).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero, and prints no
result, without a CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH = 4  # serving batch of the clip
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12  # HBM3 rate, H100 SXM data sheet
SEG_CHANNELS = {1: (8,), 4: (4, 3, 3, 2)}  # encoder / current-frame labels
# (H, W, C, labels, launches a frame) of every SPADE site of the clip
SITES = (
    (256, 192, 64, 1, 3), (128, 96, 128, 1, 3), (64, 48, 256, 1, 3), (32, 24, 512, 1, 3),
    (16, 12, 1024, 4, 6),
    (32, 24, 1024, 4, 2), (32, 24, 512, 4, 1), (64, 48, 512, 4, 2), (64, 48, 256, 4, 1),
    (128, 96, 256, 4, 2), (128, 96, 128, 4, 1), (256, 192, 128, 4, 2), (256, 192, 64, 4, 1),
)
RAGGED = (20, 13, 64, 4, 0)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def chain_inputs(torch, B, H, W, C, L, dtype, seed):
    """Random chain operands at a site, made on the CPU from a seed."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    x = rn(B, H, W, C, scale=0.5)
    ab = torch.cat([1.0 + rn(B, L, C, scale=0.1), rn(B, L, C, scale=0.1)], dim=-1)
    segs, wshs, bshs, wgbs, bgbs = [], [], [], [], []
    for cs in SEG_CHANNELS[L]:
        segs.append(rn(B, H, W, cs).to(dtype))
        wshs.append(rn(128, cs, 3, 3, scale=(9 * cs) ** -0.5))
        bshs.append(rn(128, scale=0.1))
        wgbs.append(rn(2 * C, 128, 3, 3, scale=(9 * 128) ** -0.5))
        bgbs.append(rn(2 * C, scale=0.05))
    return x.to(dtype), ab, segs, wshs, bshs, wgbs, bgbs


def to_device(args, device):
    out = []
    for a in args:
        out.append([t.to(device) for t in a] if isinstance(a, list) else a.to(device))
    return out


def site_cost(B, H, W, C, L, itemsize):
    """(FLOPs, bytes) the chain needs at a site: both 3x3 convs of every
    label, x read once, y written once, segmaps and weights read once."""
    cs = sum(SEG_CHANNELS[L])
    px = B * H * W
    flops = 2 * 9 * px * (cs * 128 + L * 128 * 2 * C)
    nbytes = (2 * px * C + px * cs + 9 * cs * 128 + L * 9 * 128 * 2 * C) * itemsize + 4 * (
        L * 128 + L * 2 * C + B * L * 2 * C)
    return flops, nbytes


def cuda_ms(torch, fn, reps):
    """Mean device time of fn over reps calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_site(torch, fs, args, site):
    """Kernel and plain version on the same bf16 operands, with the bound."""
    H, W, C, L, per_frame = site
    packed = fs.pack_weights(args[3], args[4], args[5], args[6], torch.bfloat16)
    with torch.no_grad():
        k_ms = cuda_ms(torch, lambda: fs.fused_multispade_modulate(*args, packed=packed), 5)
        p_ms = cuda_ms(torch, lambda: fs.multispade_modulate_plain(*args), 5)
    flops, nbytes = site_cost(BATCH, H, W, C, L, 2)
    bound_ms = 1e3 * max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S)
    by = "operations" if flops / H100_BF16_FLOPS >= nbytes / H100_BYTES_PER_S else "bytes"
    log(f"time bf16 B={BATCH} H={H} W={W} C={C} L={L} x{per_frame}/frame: "
        f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {bound_ms:.4f} ms ({by}) "
        f"kernel {flops / k_ms / 1e9:.2f} TFLOP/s")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by,
                per_frame=per_frame, flops=flops)


def check_chain_kernel(torch, fs):
    """Phase 3: kernel against plain version at every site of the clip, at
    the clip's batch, and at a ragged tile, in bf16 and f32 (elementwise, see
    fs.KERNEL_TOLERANCE); each bf16 site is then timed on the same operands.
    Every case is checked and printed before a failure ends the run."""
    errors, timings, failed = {}, {}, []
    for i, site in enumerate(SITES + (RAGGED,)):
        H, W, C, L, per_frame = site
        for dtype in (torch.bfloat16, torch.float32):
            args = to_device(chain_inputs(torch, BATCH, H, W, C, L, dtype, seed=i), "cuda")
            out = fs.fused_multispade_modulate(*args)
            ref = fs.multispade_modulate_plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ratio = fs.error_ratio(out, ref)
            tol = fs.KERNEL_TOLERANCE[dtype]
            name = str(dtype).split(".")[-1]
            ok = bool(torch.isfinite(out.float()).all()) and ratio <= tol
            log(f"check {name:8s} B={BATCH} H={H} W={W} C={C} L={L}: "
                f"max_abs_err={err:.4g} max_ref={ref.float().abs().max().item():.4g} "
                f"max|d|/(|ref|+rms)={ratio:.3g} (limit {tol:g}) {'ok' if ok else 'FAIL'}")
            errors[(H, W, C, L, name)] = err
            if not ok:
                failed.append(f"{(H, W, C, L)} {name}")
            elif dtype == torch.bfloat16 and per_frame:
                timings[(H, W, C, L)] = time_site(torch, fs, args, site)
            del args, out, ref
    if failed:
        raise SystemExit(f"kernel disagrees with its plain version at {', '.join(failed)}")
    return errors, timings


def check_small_clip(torch):
    """Phase 4: a small f32 clip through the kernels on the card against
    the same weights and batch through the plain versions on the CPU."""
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.models.warp_model import WarpModel
    from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate
    from shineon_tpu_torch.serving import build_inference, make_one_clip

    small = dict(fine_height=128, fine_width=96, n_frames_total=3, n_frames_now=3,
                 ngf_pow_outer=6, ngf_pow_inner=8, num_middle=1, precision=32)
    one_clip, warp, sams, raw, _ = build_inference(2, device="cuda", seed=7, **small)
    before = fused_multispade_modulate.launches
    out = one_clip(raw).cpu()
    launched = fused_multispade_modulate.launches - before
    cpu_sams, cpu_warp = SamsModel(sams.opt, "cpu"), WarpModel(warp.opt, "cpu")
    cpu_sams.generator.load_state_dict(sams.generator.state_dict())
    cpu_warp.gmm.load_state_dict(warp.gmm.state_dict())
    ref = make_one_clip(cpu_warp, cpu_sams)({k: v.cpu() for k, v in raw.items()})
    err = (out - ref).abs().max().item() / ref.abs().max().item()
    ok = launched > 0 and bool(torch.isfinite(out).all()) and err <= 1e-3
    log(f"small clip f32 (2, 3, 128, 96): card vs CPU plain max rel err {err:.3g}, "
        f"{launched} kernel launches {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("small clip on the card disagrees with the CPU plain path")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "shineon_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    from shineon_tpu_torch.ops import cuda_build
    from shineon_tpu_torch.ops import fused_spade as fs
    from shineon_tpu_torch.serving import build_inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    report = cuda_build.build(fs.KERNEL_SOURCE)
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas {fs.KERNEL_SOURCE}: {line.strip()}")

    errors, timings = check_chain_kernel(torch, fs)
    check_small_clip(torch)

    t0 = time.perf_counter()
    one_clip, warp, sams, raw, n_frames = build_inference(batch_size=BATCH)
    torch.cuda.synchronize()
    log(f"clip built and warmed (3 rollouts): {time.perf_counter() - t0:.1f} s")
    one_clip(raw)  # warm-up call
    torch.cuda.synchronize()
    fs.fused_multispade_modulate.launches = 0
    frames = one_clip(raw)
    torch.cuda.synchronize()
    launches = fs.fused_multispade_modulate.launches
    expected = n_frames * sum(site[4] for site in SITES)
    shape = (BATCH, n_frames, 256, 192, 3)
    finite = bool(torch.isfinite(frames.float()).all())
    log(f"clip: frames {tuple(frames.shape)} {frames.dtype} finite={finite} "
        f"max|frame|={frames.float().abs().max().item():.4g} "
        f"fused_multispade launches={launches} (expected {expected})")
    if tuple(frames.shape) != shape or not finite or launches != expected:
        raise SystemExit("serving clip failed its checks")

    clip_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_clip(raw)
        torch.cuda.synchronize()
        clip_s.append(time.perf_counter() - t0)
    med = statistics.median(clip_s)
    kernel_clip_ms = sum(t["ms"] * t["per_frame"] * n_frames for t in timings.values())
    bound_clip_ms = sum(t["bound_ms"] * t["per_frame"] * n_frames for t in timings.values())
    log(f"clip time: median {med * 1e3:.1f} ms of {[round(s * 1e3, 1) for s in clip_s]} ms, "
        f"{BATCH * n_frames / med:.2f} frames/s, batch {BATCH} x {n_frames} frames "
        f"[{card}]")
    log(f"fused_multispade per clip from the site timings: {kernel_clip_ms:.1f} ms "
        f"({expected} launches), bound {bound_clip_ms:.2f} ms")

    top = max(timings, key=lambda k: timings[k]["flops"])
    t = timings[top]
    kernels = [{
        "name": "fused_multispade",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/fused_multispade.cu",
        "replaces": "shineon_tpu/ops/fused_spade.py:212",
        "launches": launches,
        "max_abs_err": errors[top + ("bfloat16",)],
        "max_abs_err_f32": errors[top + ("float32",)],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "site": {"B": BATCH, "H": top[0], "W": top[1], "C": top[2], "L": top[3],
                 "dtype": "bfloat16"},
        "clip_ms": med * 1e3,
        "clip_kernel_ms": kernel_clip_ms,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
