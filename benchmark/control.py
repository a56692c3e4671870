"""Readings that the limits of ``correct`` are set from, on the card at a
cell's own size, many seeds in one process:

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 ... \
        [--control | --faults | --plant NAME] [--seconds 3] [--out FILE]

For each seed it builds the cell's served clip as a run does, runs a short
closed loop at the cell's load, and judges the same hand-ins a run judges
(two drawn from the seed and the last) against the reference. With
``--control`` it reads the control in place of the program: the reference
computed in the next precision below the configuration's, run on its own
frames and judged like the program (float8 e4m3 for a bf16 configuration,
4 bits for an int8 one). With ``--faults`` it reads, on the same outputs,
each fault of benchmark/faults.py's ``NAMES`` as it would have left them;
with ``--plant`` the program runs its window with that fault of
``PLANTED`` inside it. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import faults as planted
from benchmark import registry, run


def readings(workload: str, seed: int, control: bool, seconds: float, device="cuda",
             faults: bool = False, plant: str = None) -> dict:
    spec = registry.load_spec()
    cell = registry.cell(spec, workload)
    cfg = registry.config(spec, cell["config"])
    mix = registry.traffic(cell["traffic"])
    ent = registry.entry(cfg["entry"])
    int8 = bool(cfg["options"].get("int8_spade"))
    t0 = time.perf_counter()
    served = ent.build(cfg, mix, seed, device)
    if plant:
        planted.plant(served, plant)
    win, kept = run.judged_window(served, seed, seconds, mix["in_flight"], device == "cuda",
                                  keep=(0,) if faults else ())
    first = kept.pop(0) if faults and 0 not in run.sample_indices(seed) else kept.get(0)
    served.free()
    opt = cfg["options"]
    if control:
        from benchmark.reference import sams_clip as ref

        with ref.plain_precision(), torch.no_grad():
            state = ref.warm_up(served.weights, ref.features(served.traffic.hand_in(0), opt), opt)
            kept = {i: ref.clip_frames(served.weights, state, served.traffic.hand_in(i), opt,
                                       bits=4 if int8 else "fp8")[0] for i in kept}
    bits = 8 if int8 else None
    got = ent.judge(kept, served.traffic, served.weights, opt, bits)
    got["per_clip"] = {str(k): v for k, v in got["per_clip"].items()}
    if faults:
        for name in planted.NAMES:
            broken = planted.apply(name, kept, first)
            got[name] = ent.judge(broken, served.traffic, served.weights, opt, bits)["frame_rel_rms"]
    return {"workload": workload, "seed": seed, "control": control, "plant": plant,
            "hand_ins": len(win.clips),
            "judged": sorted(kept), **got, "seconds": round(time.perf_counter() - t0, 1)}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", action="store_true")
    p.add_argument("--plant", choices=planted.PLANTED)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        line = json.dumps(readings(args.workload, seed, args.control, args.seconds,
                                     faults=args.faults, plant=args.plant))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
