#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shineon_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: torch's device name and count, and nvidia-smi's name and
     power limit;
  2. build the hand-written kernels from csrc/ (one nvcc a source, all at
     once) and print their ptxas reports;
  3. hold each kernel against its plain PyTorch version at every shape the
     serving clip gives it (the clip's batch), in bf16 and f32, plus a
     ragged tile, element by element, and time kernel and plain version on
     the same bf16 operands: the full-precision chain (3a), the quantized
     chain with its pre-pass (3b, also held in rms, with two controls that
     must fail its limits, and timed against the full-precision chain on
     the same operands) and the int8 3x3 conv (3c, on inputs of both signs,
     also timed against cuDNN's bf16 conv of the same shape, the conv it
     replaces);
  4. check the whole clip on a small input: the kernel path on the card
     against the plain path on the CPU, same weights, f32; then the same
     with int8 serving, printing the int8 clip's distance from the fp one;
  5. build the serving clip at full width (256x192, 5 frames, widths
     2^6..2^10, batch 4, bf16, random weights from a seed, warmed running
     statistics), run it once with every launch counter at 0, check the
     frames and that every kernel of the path was launched as often as the
     model has sites; then the same for the int8 serving clip
     (int8_spade=True), whose path runs the quantized chain, its pre-pass
     and the int8 conv; then time the two clips in turns (median of 5 each
     after a warm-up call).

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BATCH = 4  # serving batch of the clip
H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM data sheet
H100_INT8_OPS = 1979e12  # dense int8 tensor-core peak, H100 SXM data sheet
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
# (H, W, Cin, Cout, launches a frame) of every int8 3x3 conv of the int8 clip
CONVS = (
    (256, 192, 64, 64, 2), (256, 192, 64, 128, 1), (256, 192, 128, 64, 1),
    (128, 96, 128, 128, 2), (128, 96, 128, 256, 1), (128, 96, 256, 128, 1),
    (64, 48, 256, 256, 2), (64, 48, 256, 512, 1), (64, 48, 512, 256, 1),
    (32, 24, 512, 512, 2), (32, 24, 512, 1024, 1), (32, 24, 1024, 512, 1),
    (16, 12, 1024, 1024, 6),
)
RAGGED_CONV = (20, 13, 64, 128, 0)


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


def bound(ops_s, nbytes):
    """(bound ms, what bounds it): the larger of the operations' time at the
    card's peak rates and the bytes' time at its memory rate."""
    byte_s = nbytes / H100_BYTES_PER_S
    return 1e3 * max(ops_s, byte_s), "operations" if ops_s >= byte_s else "bytes"


def int8_site_bound(B, H, W, C, L):
    """The quantized chain with its pre-pass at a site, bf16: the hidden conv
    twice (pre-pass and chain) at the bf16 rate, the gamma/beta conv at the
    int8 rate; x, y, segmaps and hidden weights in bf16, gamma/beta weights
    in int8, each moved once."""
    cs = sum(SEG_CHANNELS[L])
    px = B * H * W
    hid_flops = 2 * (2 * 9 * px * cs * 128)
    gb_ops = 2 * 9 * px * L * 128 * 2 * C
    nbytes = (2 * (2 * px * C + px * cs + 9 * cs * 128) + L * 9 * 128 * 2 * C
              + 4 * (L * 128 + 2 * L * 2 * C + B * L * 2 * C + L))
    ms, by = bound(hid_flops / H100_BF16_FLOPS + gb_ops / H100_INT8_OPS, nbytes)
    return ms, by, hid_flops + gb_ops


def conv_bound(B, H, W, cin, cout, itemsize=2):
    """The int8 3x3 conv: its int8 operations against x read and y written
    once in the activation dtype, int8 weights and f32 scales and bias."""
    ops = 2 * 9 * B * H * W * cin * cout
    nbytes = B * H * W * (cin + cout) * itemsize + 9 * cin * cout + 4 * (2 * cout + 1)
    ms, by = bound(ops / H100_INT8_OPS, nbytes)
    return ms, by, ops


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


def int8_timings(torch, fs, args, site):
    """The quantized chain (pre-pass + chain, as the wrapper runs them), its
    pre-pass alone, its plain version and the full-precision chain kernel on
    the same bf16 operands, with the bound."""
    H, W, C, L, per_frame = site
    x, ab, segs, wshs, bshs, wgbs, bgbs = args
    packed_q = fs.pack_weights(wshs, bshs, wgbs, bgbs, torch.bfloat16, quantized=True)
    packed = fs.pack_weights(wshs, bshs, wgbs, bgbs, torch.bfloat16)
    seg = torch.cat(segs, dim=-1).contiguous()
    with torch.no_grad():
        k_ms = cuda_ms(torch, lambda: fs.fused_multispade_modulate(
            *args, packed=packed_q, quantized=True), 5)
        pre_ms = cuda_ms(torch, lambda: fs.hidden_absmax(seg, packed_q), 5)
        p_ms = cuda_ms(torch, lambda: fs.multispade_modulate_plain_int8(*args), 3)
        fp_ms = cuda_ms(torch, lambda: fs.fused_multispade_modulate(*args, packed=packed), 5)
    bound_ms, by, ops = int8_site_bound(BATCH, H, W, C, L)
    log(f"time int8 bf16 B={BATCH} H={H} W={W} C={C} L={L} x{per_frame}/frame: "
        f"kernel {k_ms:.4f} ms (pre-pass {pre_ms:.4f}) plain {p_ms:.4f} ms "
        f"bound {bound_ms:.4f} ms ({by}) bf16 chain {fp_ms:.4f} ms "
        f"kernel {ops / k_ms / 1e9:.2f} Tops/s")
    return dict(ms=k_ms, prepass_ms=pre_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by,
                bf16_chain_ms=fp_ms, per_frame=per_frame, ops=ops)


def check_int8_chain(torch, fs):
    """Phase 3b: the quantized chain (pre-pass + chain) against its plain
    version at every site and the ragged tile, bf16 and f32, element by
    element and in rms (fs.int8_chain_agrees); each bf16 site is timed. Two
    controls at every case must FAIL those limits, or the limits could not
    tell a fault from rounding: the full-precision chain kernel (no int8 at
    all) and the quantized kernel given gamma/beta weights quantized from
    their bf16 cast (a planted fault of the int8 stage)."""
    errors, timings, failed = {}, {}, []
    for i, site in enumerate(SITES + (RAGGED,)):
        H, W, C, L, per_frame = site
        for dtype in (torch.bfloat16, torch.float32):
            args = to_device(chain_inputs(torch, BATCH, H, W, C, L, dtype, seed=100 + i), "cuda")
            x, ab, segs, wshs, bshs, wgbs, bgbs = args
            out = fs.fused_multispade_modulate(*args, quantized=True)
            ref = fs.multispade_modulate_plain_int8(*args)
            fp = fs.fused_multispade_modulate(*args)
            bf16_w = [w.to(torch.bfloat16).float() for w in wgbs]
            planted = fs.fused_multispade_modulate(*args, quantized=True, packed=fs.pack_weights(
                wshs, bshs, bf16_w, bgbs, dtype, quantized=True))
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ok, ratio, rms = fs.int8_chain_agrees(out, ref)
            fp_ok, fp_ratio, fp_rms = fs.int8_chain_agrees(fp, ref)
            pl_ok, pl_ratio, pl_rms = fs.int8_chain_agrees(planted, ref)
            name = str(dtype).split(".")[-1]
            good = ok and not fp_ok and not pl_ok
            log(f"check int8 {name:8s} B={BATCH} H={H} W={W} C={C} L={L}: "
                f"max_abs_err={err:.4g} max|d|/(|ref|+rms)={ratio:.3g} rms(d)/rms(ref)={rms:.3g} "
                f"(limits {fs.KERNEL_TOLERANCE[(dtype, 'int8')]:g}, "
                f"{fs.INT8_RMS_TOLERANCE:g}); must fail: fp chain {fp_ratio:.3g}/{fp_rms:.3g}, "
                f"bf16-cast weights {pl_ratio:.3g}/{pl_rms:.3g} {'ok' if good else 'FAIL'}")
            errors[(H, W, C, L, name)] = (err, ratio, rms)
            if not good:
                failed.append(f"{(H, W, C, L)} {name}")
            elif dtype == torch.bfloat16 and per_frame:
                timings[(H, W, C, L)] = int8_timings(torch, fs, args, site)
            del args, out, ref, fp, planted
    if failed:
        raise SystemExit(f"quantized chain disagrees with its plain version (or a control "
                         f"passes) at {', '.join(failed)}")
    return errors, timings


def check_int8_conv(torch, ic, fs):
    """Phase 3c: the int8 3x3 conv against its plain version at every conv
    shape of the int8 clip and a ragged one, bf16 and f32, element by
    element (ic.INT8_CONV_TOLERANCE); each bf16 shape is timed against its
    plain version, its bound and cuDNN's bf16 conv of the same shape."""
    F = torch.nn.functional
    errors, timings, failed = {}, {}, []
    for i, shape in enumerate(CONVS + (RAGGED_CONV,)):
        H, W, cin, cout, per_frame = shape
        g = torch.Generator().manual_seed(200 + i)
        # the clip feeds the conv leaky_relu(0.2) output: both signs
        x0 = torch.nn.functional.leaky_relu(torch.randn(BATCH, H, W, cin, generator=g), 0.2).cuda()
        w = (torch.randn(cout, cin, 3, 3, generator=g) * (9 * cin) ** -0.5).cuda()
        b = (0.1 * torch.randn(cout, generator=g)).cuda()
        qw = ic.quantize_weight(w)
        for dtype in (torch.bfloat16, torch.float32):
            x = x0.to(dtype)
            out = ic.conv3x3_int8(x, qw, b, dtype)
            ref = ic.conv3x3_int8_plain(x, qw, b, dtype)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            ratio = fs.error_ratio(out, ref)
            tol = ic.INT8_CONV_TOLERANCE[dtype]
            name = str(dtype).split(".")[-1]
            ok = bool(torch.isfinite(out.float()).all()) and ratio <= tol
            log(f"check conv {name:8s} B={BATCH} H={H} W={W} {cin}->{cout}: "
                f"max_abs_err={err:.4g} max|d|/(|ref|+rms)={ratio:.3g} (limit {tol:g}) "
                f"{'ok' if ok else 'FAIL'}")
            errors[(H, W, cin, cout, name)] = err
            if not ok:
                failed.append(f"{(H, W, cin, cout)} {name}")
            elif dtype == torch.bfloat16 and per_frame:
                w_bf, b_bf = w.to(dtype), b.to(dtype)
                x_nchw = x.permute(0, 3, 1, 2)
                with torch.no_grad():
                    k_ms = cuda_ms(torch, lambda: ic.conv3x3_int8(x, qw, b, dtype), 10)
                    p_ms = cuda_ms(torch, lambda: ic.conv3x3_int8_plain(x, qw, b, dtype), 3)
                    lib_ms = cuda_ms(torch, lambda: F.conv2d(x_nchw, w_bf, b_bf, padding=1), 10)
                bound_ms, by, ops = conv_bound(BATCH, H, W, cin, cout)
                log(f"time conv bf16 B={BATCH} H={H} W={W} {cin}->{cout} x{per_frame}/frame: "
                    f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {bound_ms:.4f} ms ({by}) "
                    f"cuDNN bf16 conv {lib_ms:.4f} ms kernel {ops / k_ms / 1e9:.2f} Tops/s")
                timings[(H, W, cin, cout)] = dict(
                    ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by,
                    cudnn_bf16_ms=lib_ms, per_frame=per_frame, ops=ops)
    if failed:
        raise SystemExit(f"int8 conv disagrees with its plain version at {', '.join(failed)}")
    return errors, timings


def check_small_clip(torch):
    """Phase 4: a small f32 clip through the kernels on the card against
    the same weights and batch through the plain versions on the CPU; then
    the same clip with int8 serving (every chain quantized, and the conv
    gate's floor at 256 channels, so the middle block's two 3x3 convs run
    the int8 conv). The int8 clip's card-vs-CPU distance is printed beside
    its distance from the fp clip, and the first frame's must be under a
    quarter of it. (Quantization flips from one-ulp differences of the f32
    sums cascade through the int8 convs and the frames fed back: at these
    random weights a 1e-6 change of one weight tensor moves the whole int8
    clip by a third of its int8-vs-fp distance at this floor, by all of it
    at the default floor of 64, and its first frame by 0.07 of it here.)"""
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.models.warp_model import WarpModel
    from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate as fmm
    from shineon_tpu_torch.ops.int8_conv import conv3x3_int8
    from shineon_tpu_torch.serving import build_inference, make_one_clip

    def rel(a, b):
        return (a - b).abs().max().item() / b.abs().max().item()

    small = dict(fine_height=128, fine_width=96, n_frames_total=3, n_frames_now=3,
                 ngf_pow_outer=6, ngf_pow_inner=8, num_middle=1, precision=32)
    refs = {}
    for int8 in (False, True):
        opts = dict(int8_spade=True, int8_min_channels=256) if int8 else {}
        one_clip, warp, sams, raw, _ = build_inference(2, device="cuda", seed=7, **small, **opts)
        count = lambda: (fmm.launches, fmm.int8_launches, fmm.absmax_launches,  # noqa: E731
                         conv3x3_int8.launches)
        before = count()
        out = one_clip(raw).cpu()
        launched = [a - b for a, b in zip(count(), before)]
        cpu_sams, cpu_warp = SamsModel(sams.opt, "cpu"), WarpModel(warp.opt, "cpu")
        cpu_sams.generator.load_state_dict(sams.generator.state_dict())
        cpu_warp.gmm.load_state_dict(warp.gmm.state_dict())
        ref = make_one_clip(cpu_warp, cpu_sams)({k: v.cpu() for k, v in raw.items()})
        refs[int8] = ref
        err = rel(out, ref)
        finite = bool(torch.isfinite(out).all())
        if not int8:
            ok = launched[0] > 0 and finite and err <= 1e-3
            log(f"small clip f32 (2, 3, 128, 96): card vs CPU plain max rel err {err:.3g}, "
                f"{launched[0]} kernel launches {'ok' if ok else 'FAIL'}")
        else:
            gap, err1 = rel(refs[True], refs[False]), rel(out[:, 0], ref[:, 0])
            gap1 = rel(refs[True][:, 0], refs[False][:, 0])
            ok = (launched[0] == 0 and min(launched[1:]) > 0 and finite
                  and err1 < 0.25 * gap1)
            log(f"small clip f32 int8 (2, 3, 128, 96): card vs CPU plain max rel err "
                f"{err:.3g} (first frame {err1:.3g}), CPU int8 vs fp {gap:.3g} (first frame "
                f"{gap1:.3g}, limit a quarter of it); launches chain {launched[1]} "
                f"pre-pass {launched[2]} conv {launched[3]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("small clip on the card disagrees with the CPU plain path")


def run_clip(torch, build_inference, counters, expected, **opts):
    """Phase 5: build the full-width clip, run it once with every launch
    count at 0, check frames and launches. Returns the clip (a function of
    no argument), the launches, the frames and the number of convs the
    built generator runs in int8."""
    from shineon_tpu_torch.networks.layers import Conv2d
    from shineon_tpu_torch.networks.normalization import SpectralConv2d

    t0 = time.perf_counter()
    one_clip, warp, sams, raw, n_frames = build_inference(batch_size=BATCH, **opts)
    int8_convs = sum(1 for m in sams.generator.modules()
                     if isinstance(m, (Conv2d, SpectralConv2d)) and m.int8)
    torch.cuda.synchronize()
    log(f"clip {opts or ''} built and warmed (3 rollouts): {time.perf_counter() - t0:.1f} s")
    one_clip(raw)  # warm-up call
    torch.cuda.synchronize()
    for owner, attr in counters.values():
        setattr(owner, attr, 0)
    frames = one_clip(raw)
    torch.cuda.synchronize()
    launches = {name: getattr(owner, attr) for name, (owner, attr) in counters.items()}
    shape = (BATCH, n_frames, 256, 192, 3)
    finite = bool(torch.isfinite(frames.float()).all())
    want = {name: n_frames * per_frame for name, per_frame in expected.items()}
    log(f"clip {opts or ''}: frames {tuple(frames.shape)} {frames.dtype} finite={finite} "
        f"max|frame|={frames.float().abs().max().item():.4g} launches {launches} "
        f"(expected {want})")
    if tuple(frames.shape) != shape or not finite or launches != want:
        raise SystemExit(f"serving clip {opts or ''} failed its checks")
    return (lambda: one_clip(raw)), launches, n_frames, int8_convs


def time_clips(torch, clips, rounds=5):
    """Host time of each clip, in turns (a, b, a, b, ...), ending in a
    synchronize: median and samples in ms."""
    samples = {name: [] for name in clips}
    for _ in range(rounds):
        for name, clip in clips.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            clip()
            torch.cuda.synchronize()
            samples[name].append(1e3 * (time.perf_counter() - t0))
    return {name: (statistics.median(v), v) for name, v in samples.items()}


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
    from shineon_tpu_torch.ops import int8_conv as ic
    from shineon_tpu_torch.serving import build_inference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    log(card)

    t0 = time.perf_counter()
    sources = (fs.KERNEL_SOURCE, ic.KERNEL_SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        reports = list(pool.map(cuda_build.build, sources))
    log(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(sources)} in parallel)")
    for source, report in zip(sources, reports):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {source}: {line.strip()}")

    errors, timings = check_chain_kernel(torch, fs)
    q_errors, q_timings = check_int8_chain(torch, fs)
    c_errors, c_timings = check_int8_conv(torch, ic, fs)
    check_small_clip(torch)

    fmm = fs.fused_multispade_modulate
    n_sites = sum(site[4] for site in SITES)
    n_convs = sum(shape[4] for shape in CONVS)
    clip, launches, n_frames, _ = run_clip(
        torch, build_inference, {"fused_multispade": (fmm, "launches")},
        {"fused_multispade": n_sites})
    q_clip, q_launches, _, built = run_clip(
        torch, build_inference,
        {"fused_multispade": (fmm, "launches"), "fused_multispade_int8": (fmm, "int8_launches"),
         "multispade_hidden_absmax": (fmm, "absmax_launches"),
         "int8_conv3x3": (ic.conv3x3_int8, "launches")},
        {"fused_multispade": 0, "fused_multispade_int8": n_sites,
         "multispade_hidden_absmax": n_sites, "int8_conv3x3": n_convs},
        int8_spade=True)
    times = time_clips(torch, {"bf16": clip, "int8": q_clip})
    for name, (ms, samples) in times.items():
        log(f"clip {name} time: median {ms:.1f} ms of {[round(v, 1) for v in samples]} ms, "
            f"{BATCH * n_frames / ms * 1e3:.2f} frames/s, batch {BATCH} x {n_frames} frames, "
            f"timed in turns [{card}]")
    med, q_med = times["bf16"][0] / 1e3, times["int8"][0] / 1e3

    # the int8 model's own count of int8 convs, against the list above
    log(f"int8 convs in the built generator: {built} (expected {n_convs} a frame)")
    if built != n_convs:
        raise SystemExit("the int8 generator's conv count disagrees with the conv list")

    def per_clip(tim):
        return (sum(t["ms"] * t["per_frame"] * n_frames for t in tim.values()),
                sum(t["bound_ms"] * t["per_frame"] * n_frames for t in tim.values()))

    for name, tim in (("fused_multispade", timings), ("fused_multispade_int8", q_timings),
                      ("int8_conv3x3", c_timings)):
        k, b = per_clip(tim)
        log(f"{name} per clip from the shape timings: {k:.1f} ms, bound {b:.2f} ms")
    cudnn_clip = sum(t["cudnn_bf16_ms"] * t["per_frame"] * n_frames for t in c_timings.values())
    log(f"cuDNN bf16 conv at the same shapes per clip: {cudnn_clip:.1f} ms")
    log(f"clip latency bf16 {med * 1e3:.1f} ms, int8 {q_med * 1e3:.1f} ms "
        f"({BATCH * n_frames / med:.2f} vs {BATCH * n_frames / q_med:.2f} frames/s) [{card}]")

    top = max(timings, key=lambda k: timings[k]["flops"])
    q_top = max(q_timings, key=lambda k: q_timings[k]["ops"])
    c_top = max(c_timings, key=lambda k: c_timings[k]["ops"])
    t, qt, ct = timings[top], q_timings[q_top], c_timings[c_top]
    site = lambda k: {"B": BATCH, "H": k[0], "W": k[1], "C": k[2], "L": k[3],  # noqa: E731
                      "dtype": "bfloat16"}
    kernels = [{
        "name": "fused_multispade",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/fused_multispade.cu",
        "replaces": "shineon_tpu/ops/fused_spade.py:212",
        "launches": launches["fused_multispade"],
        "max_abs_err": errors[top + ("bfloat16",)],
        "max_abs_err_f32": errors[top + ("float32",)],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "site": site(top),
        "clip_ms": med * 1e3,
        "clip_kernel_ms": per_clip(timings)[0],
    }, {
        "name": "fused_multispade_int8",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/fused_multispade.cu",
        "replaces": "shineon_tpu/ops/fused_spade.py:212 (quant=True)",
        "launches": q_launches["fused_multispade_int8"],
        "prepass_launches": q_launches["multispade_hidden_absmax"],
        "max_abs_err": q_errors[q_top + ("bfloat16",)][0],
        "max_abs_err_f32": q_errors[q_top + ("float32",)][0],
        "ms": qt["ms"],
        "prepass_ms": qt["prepass_ms"],
        "plain_ms": qt["plain_ms"],
        "bound_ms": qt["bound_ms"],
        "bound_by": qt["bound_by"],
        "library_ms": None,
        "bf16_chain_ms": qt["bf16_chain_ms"],
        "site": site(q_top),
        "clip_ms": q_med * 1e3,
        "clip_kernel_ms": per_clip(q_timings)[0],
    }, {
        "name": "int8_conv3x3",
        "route": "cuda",
        "source": "shineon_tpu_torch/csrc/int8_conv3x3.cu",
        "replaces": "tools/pallas_conv_probe.py:282",
        "launches": q_launches["int8_conv3x3"],
        "max_abs_err": c_errors[c_top + ("bfloat16",)],
        "max_abs_err_f32": c_errors[c_top + ("float32",)],
        "ms": ct["ms"],
        "plain_ms": ct["plain_ms"],
        "bound_ms": ct["bound_ms"],
        "bound_by": ct["bound_by"],
        "library_ms": None,
        "cudnn_bf16_ms": ct["cudnn_bf16_ms"],
        "site": {"B": BATCH, "H": c_top[0], "W": c_top[1], "Cin": c_top[2], "Cout": c_top[3],
                 "dtype": "bfloat16"},
        "clip_ms": q_med * 1e3,
        "clip_kernel_ms": per_clip(c_timings)[0],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
