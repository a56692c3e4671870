"""Finds what ``BENCHMARK.json`` names, by name, as files of their own
under the benchmark's folder: ``configs/<name>.json``,
``traffic/<name>.json``, ``metrics/<name>.py`` (a module with ``read(ctx)``)
and ``entries/<name>.py`` (the system under test of a configuration). A
later configuration, mix or metric is added as new files alone."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell(spec: dict, workload: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((Path(bench_dir) / "traffic" / f"{name}.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, bench_dir: Path = BENCH_DIR):
    """The reader of per-layer metric ``name``: ``read(ctx)`` returns its
    number, or None where the run holds nothing to read."""
    return _module(Path(bench_dir) / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def entry(name: str, bench_dir: Path = BENCH_DIR):
    return _module(Path(bench_dir) / "entries" / f"{name}.py", f"benchmark_entry_{name}")


def applies(metric_spec: dict, workload: str) -> bool:
    """Whether a metric of BENCHMARK.json is reported in ``workload``."""
    return "workloads" not in metric_spec or workload in metric_spec["workloads"]
