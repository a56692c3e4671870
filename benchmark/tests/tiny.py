"""A tiny copy of the benchmark for the CPU tests: the benchmark folder
copied under a temporary root, with a BENCHMARK.json of one configuration
at 128x96 (widths 8..32, one middle block, 3 frames, batch 2, f32 around
the int8 convs where the configuration serves int8) and the
production cells' traffic cut to that batch."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import registry

TINY_OPTIONS = dict(fine_height=128, fine_width=96, n_frames_total=3, n_frames_now=3,
                    ngf_pow_outer=3, ngf_pow_inner=5, num_middle=1, ngf=8, precision=32,
                    int8_min_channels=16)
# the tiny f32 clip against the reference: 6.9e-5 and 8.2e-5 on the CPU
# (relative rms, two seeds; the SPADE modulation at its configured gain
# amplifies summation-order differences); the limit leaves room for other
# hosts' convolution orders, far under the faults' 0.8-1.0
TINY_LIMIT = 1e-3
# the tiny int8 clip (f32 around the int8 convs) against the 8-bit
# reference: 0.040 and 0.045 (quantization flips from summation orders);
# the wrong hidden scale reads 0.83-0.88, the 4-bit control 1.7-2.4
TINY_INT8_LIMIT = 0.2


def make_root(tmp: Path, int8: bool = False) -> Path:
    """A checkout root under ``tmp`` holding the benchmark and a tiny
    BENCHMARK.json with the cells ``tiny.offline`` and ``tiny.sync``."""
    root = Path(tmp) / "root"
    shutil.copytree(registry.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    spec = registry.load_spec()
    base = registry.config(spec, "sams_int8" if int8 else "sams_bf16")
    cfg = {**base, "name": "tiny", "options": {**base["options"], **TINY_OPTIONS},
           "checks": {"frame_rel_rms": TINY_INT8_LIMIT if int8 else TINY_LIMIT, "nonfinite": 0.0}}
    (root / "benchmark" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    for mix in ("offline", "sync"):
        t = registry.traffic(f"b16.{mix}")
        t.update(batch=2, pool=2)
        (root / "benchmark" / "traffic" / f"tiny.{mix}.json").write_text(json.dumps(t))
    spec["configs"] = [{**spec["configs"][0], "name": "tiny", "file": "benchmark/configs/tiny.json"}]
    spec["workloads"] = [
        {"name": f"tiny.{mix}", "config": "tiny", "traffic": f"tiny.{mix}", "chips": 1, "why": "test"}
        for mix in ("offline", "sync")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.sync"] if any(w.endswith("sync") for w in m["workloads"]) else ["tiny.offline"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
