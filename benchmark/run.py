"""The benchmark of the PyTorch/CUDA port (``shineon_tpu_torch``) on one
H100:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell; its
configuration, traffic mix and per-layer metrics are files found by name
(benchmark/registry.py). Set-up builds the served clip with weights drawn
on the device from the seed and warms it; the window is a closed loop of
hand-ins (benchmark/window.py); with ``--trace 1`` a few hand-ins of a
steady stretch are traced (benchmark/trace.py) and the per-layer metrics
are read from them (benchmark/trace.py). After the window the sampled clips are judged against
the plain reference (benchmark/reference/), each number compared printed
beside its limit as the last lines of standard error, and one JSON line is
printed as the last line of standard output.

Exit codes: 0 with a result line (``correct`` may be false); 3 without the
CUDA devices the cell needs; 4 when a forbidden module (JAX, flax, optax or
the JAX package) was loaded; 5 when the trace held no marked clip.
"""

from __future__ import annotations

import time

_IMPORTED = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "shineon_tpu")
TRACE_CLIPS = 6  # hand-ins of each traced stretch
SAMPLE = 2  # hand-ins drawn from the seed among the first SAMPLE_FROM, beside the last one
SAMPLE_FROM = 16


def process_start() -> float:
    """When this process began (epoch seconds), from /proc; the moment this
    module was imported where /proc does not say."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _IMPORTED


def set_env(root: Path):
    """Every build and kernel cache inside the checkout at a fixed path (the
    port builds its kernels into shineon_tpu_torch/_build/ by itself); one
    host thread for torch's CPU work, so that idle worker threads take no
    core from the thread that launches the clip."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    cache = root / "benchmark" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), or "" without it."""
    if shutil.which("nvidia-smi") is None:
        return ""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class _Done:
    """A hand-in's completion: a CUDA event recorded after the call."""

    def __init__(self, cuda: bool):
        import torch

        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


def sample_indices(seed: int) -> list:
    return sorted(random.Random(seed).sample(range(SAMPLE_FROM), SAMPLE))


def judged_window(served, seed: int, seconds: float, in_flight: int, cuda: bool,
                  clock=time.perf_counter, prof=None, keep=()):
    """The window over ``served``'s hand-ins (window.run); returns it and
    the frames to judge: {hand-in: frames} of two hand-ins drawn from the
    seed among the first SAMPLE_FROM that the window reached, the last
    one, and those in ``keep``."""
    from benchmark import window

    wanted = set(sample_indices(seed)) | set(keep)
    kept, last = {}, {}

    def submit(i):
        o = served.one_clip(served.traffic.hand_in(i))
        if i in wanted:
            kept[i] = o
        last.clear()
        last[i] = o
        return _Done(cuda)

    win = window.run(submit, seconds, in_flight, clock, prof)
    kept.update(last)
    return win, kept


def main(argv=None, *, root: Path | None = None, device: str = "cuda", check_device: bool = True,
         clock=time.perf_counter, fault=None, out=None, err=None) -> int:
    """Run one cell; returns the exit code. The keyword arguments serve the
    tests: another checkout root, the CPU in place of the card (no device
    check), an injected clock, and ``fault(served)`` breaking the timed
    path before the window."""
    from benchmark import registry, trace as tracing, window

    out, err = out or sys.stdout, err or sys.stderr
    started = process_start() if check_device else time.time()
    args = parse(argv)
    root = Path(root) if root is not None else registry.ROOT
    bench_dir = root / "benchmark"
    set_env(root)
    spec = registry.load_spec(root)
    cell = registry.cell(spec, args.workload)
    cfg = registry.config(spec, cell["config"], root)
    mix = registry.traffic(cell["traffic"], bench_dir)

    import torch

    cuda = device == "cuda"
    if check_device and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=err)
        return 3
    if cuda:
        torch.set_num_threads(1)
        torch.cuda.reset_peak_memory_stats()
        card = card_line()
        print(f"benchmark: {args.workload} seed {args.seed} on {card or torch.cuda.get_device_name(0)}",
              file=err, flush=True)
    ent = registry.entry(cfg["entry"], bench_dir)
    served = ent.build(cfg, mix, args.seed, device)
    if fault is not None:
        fault(served)
    B, N = mix["batch"], cfg["options"]["n_frames_total"]

    # every shape the window uses, once a slot in flight, then settled
    for j in range(mix["in_flight"] + 1):
        served.one_clip(served.traffic.hand_in(j))
    if cuda:
        torch.cuda.synchronize()
    prof = tracing.Profiled(args.seconds, TRACE_CLIPS) if args.trace and cuda else None
    if prof is not None:
        tracing.marker_names()

    counts0 = ent.counters()
    gc.collect()
    gc.freeze()  # set-up's objects need no more collection passes in the window
    setup_s = time.time() - started
    win, kept = judged_window(served, args.seed, args.seconds, mix["in_flight"], cuda, clock, prof)
    gc.unfreeze()
    counts = {k: (v - counts0[k]) / len(win.clips) for k, v in ent.counters().items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    served.free()
    tr = prof.collect() if prof is not None else None
    t_check = time.perf_counter()
    checks = ent.check(cfg, kept, served.traffic, served.weights)
    check_s = time.perf_counter() - t_check
    limits = cfg["checks"]
    per_clip = checks.pop("per_clip", {})
    checks.pop("per_frame", None)
    correct = all(checks[name] <= limit for name, limit in limits.items())
    failed = sum(1 for v in per_clip.values() if not v <= limits["frame_rel_rms"])

    metrics = {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(win.clips), "failed": failed}
    if args.trace:
        if tr is None or not tr.clips:
            print("benchmark: the trace holds no marked clip", file=err)
            return 5
        ctx = SimpleNamespace(workload=args.workload, cfg=cfg, opt=cfg["options"], mix=mix,
                              batch=B, frames=N, window=win, trace=tr, memory_peak_bytes=peak)
        for m in spec["per_layer"]:
            if registry.applies(m, args.workload):
                v = registry.metric(m["name"], bench_dir).read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"] = tracing.busy_s(tr)
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tracing.top_ops(tr),
                               "idle_gaps": tracing.idle_gaps(prof.labelled)}
    else:
        e2e = {"setup_s": lambda: setup_s,
               "frames_per_s": lambda: window.frames_per_s(win, B, N),
               "clip_p90_ms": lambda: window.clip_p90_ms(win)}
        for m in spec["end_to_end"]:
            if registry.applies(m, args.workload):
                metrics[m["name"]] = {"value": e2e[m["name"]](), "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["checks"] = {name: {"value": checks[name] if math.isfinite(checks[name]) else None,
                               "limit": limit} for name, limit in limits.items()}

    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=err)
        return 4
    print(f"benchmark: {len(win.clips)} hand-ins in {win.seconds:.3f} s, set-up {setup_s:.3f} s, "
          f"judged hand-ins {sorted(kept)} in {check_s:.1f} s"
          + (f", trace reduced in {prof.reduce_s:.1f} s" if prof is not None else ""), file=err)
    print(f"benchmark: launches a hand-in {json.dumps(counts)}", file=err)
    thirds = [[c for c in win.clips if k * win.seconds / 3 <= c.done - win.start < (k + 1) * win.seconds / 3]
              for k in range(3)]
    print("benchmark: frames/s by third of the window "
          + " ".join(f"{len(t) * B * N / (win.seconds / 3):.1f}" for t in thirds), file=err)
    for name, c in result["checks"].items():
        print(f"check {name} = {checks[name]!r} limit {c['limit']!r} "
              f"{'ok' if checks[name] <= c['limit'] else 'FAIL'}", file=err)
    err.flush()
    print(json.dumps(result, allow_nan=False), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
