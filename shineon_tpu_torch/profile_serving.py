"""Where the serving clip's device time goes, on one CUDA card.

    python3 -m shineon_tpu_torch.profile_serving [--batch 4] [--int8] [--attention]

Builds the full-width clip (as chip_smoke.py does; ``--int8`` the int8
serving clip, ``int8_spade=True``; ``--attention`` the attention clip, with
attention in the last middle block and decoder block 1), runs one warm-up
call, then traces one clip with torch.profiler and prints the wall time,
the summed device time of all kernels, the device's idle share, and the
kernels that took the most device time, grouped by name.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from shineon_tpu_torch.options import ATTENTION_PLACEMENT
from shineon_tpu_torch.serving import build_inference


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--int8", action="store_true", help="trace the int8 serving clip")
    parser.add_argument("--attention", action="store_true",
                        help="trace the attention clip (options.ATTENTION_PLACEMENT)")
    args = parser.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    placement = ATTENTION_PLACEMENT if args.attention else {}
    one_clip, _, _, raw, n_frames = build_inference(args.batch, int8_spade=args.int8,
                                                    **placement)
    one_clip(raw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_clip(raw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"card: {card}")
    mode = ("int8" if args.int8 else "bf16") + (" attention" if args.attention else "")
    print(f"clip {mode} batch {args.batch} x {n_frames} frames: wall {wall_ms:.2f} ms (traced), "
          f"device busy {device_ms:.2f} ms, idle share {1 - device_ms / wall_ms:.3f}")
    print(f"{'device ms':>10} {'share':>6} {'calls':>6}  kernel")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[: args.top]:
        ms = e.self_device_time_total / 1e3
        print(f"{ms:10.3f} {ms / device_ms:6.3f} {e.count:6d}  {e.key[:110]}")
    if device_ms <= 0:
        raise SystemExit("the trace shows no device time")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
