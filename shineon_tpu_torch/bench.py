"""The port's bench, training half (counterpart of bench.py::build_train and
bench.py::measure_train; the inference half is still to come), and the
training entry point of the three models (:func:`build_train`).

    python3 -m shineon_tpu_torch.bench [--no-remat] [--attention] [--trace]

Times the SAMS training step at the production options (256x192, 5-frame
clips, widths 2^6..2^10, 3 middle blocks, bf16 with f32 parameters, batch
4, ``remat`` on as bench.py's build_train sets it): the exact step, whose
discriminator updates see the clip regenerated by the updated generator,
and the ``fast_gan_step`` variant. Each is the median, with min and max, of
REPEATS windows of TRAIN_STEPS chained steps after one warm-up step, timed
by the host clock and closed by ``torch.cuda.synchronize()`` and a fetch of
the loss. Prints one JSON line with bench.py's training field names, the
peak device memory of each variant, and the card's name and power limit.
MFU counts the port's copy of bench.py's analytic generator FLOPs, five
clip forwards a step (bench.py:339-341), against the H100's dense bf16
peak. ``--trace`` instead traces one exact step with torch.profiler and
prints its wall time, device busy time, idle share and the kernels that
took the most device time. Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from shineon_tpu_torch.options import ATTENTION_PLACEMENT, sams_options
from shineon_tpu_torch.serving import resolve_device, synthetic_raw_batch

TRAIN_BATCH = 4  # the reference SAMS production batch (bench.py:82)
TRAIN_STEPS = 8
REPEATS = 3
PEAK_FLOPS = 989e12  # H100 SXM, dense bf16


def build_train(batch_size: int, device="cuda", seed: int = 420, steps_per_epoch: int = 1000,
                model: str = "sams", **overrides):
    """A training step at a documented configuration: ``model`` "sams" the
    production SAMS options (``remat`` on unless overridden), "warp" the
    GMM's (options.gmm_options), "unet_mask" TOM's (options.tom_options);
    ``overrides`` replace any option. Every network is drawn from a
    ``torch.Generator`` seeded with ``seed`` by the JAX package's init
    rules, and the raw batch from ``seed`` 0. Runs on the card unless
    ``device`` says otherwise. Returns (model, state, step, raw_batch,
    n_frames): ``step(state, raw_batch)`` updates ``state`` in place and
    returns the metrics."""
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.models.unet_mask_model import UnetMaskModel
    from shineon_tpu_torch.models.warp_model import WarpModel
    from shineon_tpu_torch.options import gmm_options, tom_options

    device = resolve_device(device)
    base = {"batch_size": batch_size, "is_train": True}
    if model == "sams":
        opt, cls = sams_options(**{**base, "remat": True, **overrides}), SamsModel
    elif model == "warp":
        opt, cls = gmm_options(**{**base, **overrides}), WarpModel
    elif model == "unet_mask":
        opt, cls = tom_options(**{**base, **overrides}), UnetMaskModel
    else:
        raise ValueError(f"unknown model: {model!r}")
    net = cls(opt, device)
    state = net.init_state(torch.Generator().manual_seed(seed), steps_per_epoch)
    raw = synthetic_raw_batch(opt, batch_size, device=device)
    return net, state, net.make_train_step(), raw, opt.n_frames_total


def analytic_generator_flops(batch: int, h: int = 256, w: int = 192) -> float:
    """bench.py::_analytic_generator_flops: the conv FLOPs of one
    SamsGenerator forward at the production options (ngf_base 2, pows
    6..10, 3 middle blocks, labelmaps of 4/3/3/2 channels, an 8-channel
    encoder labelmap)."""
    nh = 128

    def conv(px, cin, cout, k):
        return 2.0 * k * k * cin * cout * px

    def spade(px, c, labels):
        return sum(conv(px, cs, nh, 3) + 2 * conv(px, nh, c, 3) for cs in labels)

    cur, enc_seg = [4, 3, 3, 2], [8]
    px = [batch * (h >> s) * (w >> s) for s in range(5)]  # full .. 16x12
    total = conv(px[0], 12, 64, 3) + conv(px[0], 64, 4, 3)
    widths = [64, 128, 256, 512, 1024]
    for i in range(4):  # encoder blocks
        fin, fout = widths[i], widths[i + 1]
        total += 2 * spade(px[i], fin, enc_seg) + spade(px[i], fin, enc_seg)
        total += conv(px[i], fin, fin, 3) + conv(px[i], fin, fout, 3) + conv(px[i], fin, fout, 1)
    for _ in range(3):  # middle blocks at 16x12
        total += 2 * spade(px[4], 1024, cur) + 2 * conv(px[4], 1024, 1024, 3)
    for i in range(4):  # decoder blocks
        fin, fout = widths[4 - i], widths[3 - i]
        p = px[3 - i]
        total += 2 * spade(p, fin, cur) + spade(p, fout, cur)
        total += conv(p, fin, fout, 3) + conv(p, fout, fout, 3) + conv(p, fin, fout, 1)
    return total


def time_train_steps(step, state, batch, repeats: int = REPEATS, steps: int = TRAIN_STEPS,
                     loss_key: str = "loss"):
    """Seconds a step: (median, min, max) over ``repeats`` windows of
    ``steps`` chained steps, after one warm-up step; each window ends in a
    synchronize (on the card: the device of the batch's tensors) and a
    fetch of the loss (metric ``loss_key``)."""
    cuda = any(torch.is_tensor(v) and v.is_cuda for v in batch.values())
    float(step(state, batch)[loss_key])
    times = []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step(state, batch)
        if cuda:
            torch.cuda.synchronize()
        loss = float(metrics[loss_key])
        times.append((time.perf_counter() - t0) / steps)
    if loss != loss or abs(loss) == float("inf"):
        raise RuntimeError(f"the train step gave loss={loss}")
    return statistics.median(times), min(times), max(times)


def measure_variant(fast: bool, remat: bool, batch: int = TRAIN_BATCH, **overrides):
    """Build and time one step variant; (median, min, max, peak GiB)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, state, step, raw, _ = build_train(batch, fast_gan_step=fast, remat=remat, **overrides)
    median, lo, hi = time_train_steps(step, state, raw)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, step, raw
    return median, lo, hi, peak


def measure_train(remat: bool = True, attention: bool = False) -> dict:
    resolve_device("cuda")
    placement = ATTENTION_PLACEMENT if attention else {}
    n_frames = sams_options().n_frames_total
    dt, lo, hi, peak = measure_variant(False, remat, **placement)
    f_dt, f_lo, f_hi, f_peak = measure_variant(True, remat, **placement)
    # the generator's forward and remat'd backward ~ 4 clip forwards, +1 for
    # the exact step's regeneration; discriminators and VGG not counted
    train_flops = 5.0 * n_frames * analytic_generator_flops(TRAIN_BATCH)
    frames = TRAIN_BATCH * n_frames
    return {
        "train_frames_per_sec_per_chip": frames / dt,
        "train_step_ms": dt * 1e3,
        "train_step_ms_min": lo * 1e3,
        "train_step_ms_max": hi * 1e3,
        "train_mfu": train_flops / dt / PEAK_FLOPS,
        "train_step_flops": train_flops,
        "peak_mem_gib": peak,
        "train_fast_gan_frames_per_sec_per_chip": frames / f_dt,
        "train_fast_gan_step_ms": f_dt * 1e3,
        "train_fast_gan_step_ms_min": f_lo * 1e3,
        "train_fast_gan_step_ms_max": f_hi * 1e3,
        "fast_gan_peak_mem_gib": f_peak,
        "remat": remat,
        "attention": attention,
        "batch": TRAIN_BATCH,
        "steps_per_window": TRAIN_STEPS,
        "repeats": REPEATS,
    }


def traced_step(step, state, raw):
    """One step under torch.profiler, device activity only (the host's
    thousands of ops a step would swell the trace): (wall ms, the device
    kernels' key_averages, device busy ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise RuntimeError("the profiler shows no device time in the training step")
    return wall_ms, kernels, busy_ms


def trace_step(attention: bool = False, top: int = 15) -> None:
    """Trace one exact step (after two untraced ones) and print where its
    device time goes, as profile_serving.py does for a clip."""
    placement = ATTENTION_PLACEMENT if attention else {}
    _, state, step, raw, _ = build_train(TRAIN_BATCH, **placement)
    for _ in range(2):
        step(state, raw)
    wall_ms, kernels, busy = traced_step(step, state, raw)
    print(f"exact step{' with attention' if attention else ''}, batch {TRAIN_BATCH}, remat: "
          f"wall {wall_ms:.2f} ms (traced), device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3
        print(f"{ms:10.3f} {ms / busy:6.3f} {e.count:6d}  {e.key[:110]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--no-remat", dest="remat", action="store_false",
                        help="keep every frame's activations (no recompute)")
    parser.add_argument("--attention", action="store_true",
                        help="attention in the last middle block and decoder block 1")
    parser.add_argument("--trace", action="store_true",
                        help="trace one exact step instead of timing")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.trace:
        trace_step(args.attention)
        return 0
    result = measure_train(args.remat, args.attention)
    result.update(device=torch.cuda.get_device_name(0), card=card)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
