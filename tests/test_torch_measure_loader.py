"""The host input-pipeline tool (shineon_tpu_torch/tools/input_pipeline.py)
on the CPU at a tiny tree: its loader gives the same batches in the same
order at 0 and 2 decode threads, and its command line with --device cpu
reports each thread count."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shineon_tpu_torch.tools import input_pipeline
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(videos=2, frames=6, n_frames=3, height=64, width=48, batch=2)


def test_loader_threads_give_the_same_batches(tmp_path):
    """0 and 2 threads: the same batches, key by key and value by value, in
    the same order, as CPU tensors of the arrays."""
    dataset = input_pipeline.build_dataset(str(tmp_path), **SMALL)
    runs = [list(input_pipeline.device_batches(input_pipeline.make_loader(dataset, 2, w), "cpu"))
            for w in (0, 2)]
    assert len(runs[0]) == len(dataset) // 2 == len(runs[1]) > 1
    for a, b in zip(*runs):
        assert sorted(a) == sorted(b)
        for k in a:
            if torch.is_tensor(a[k]):
                assert a[k].device.type == "cpu" and torch.equal(a[k], b[k]), k
            else:
                assert np.array_equal(np.asarray(a[k], dtype=object),
                                      np.asarray(b[k], dtype=object)), k
    assert any(torch.is_tensor(v) and v.dtype == torch.uint8 for v in runs[0][0].values())


def test_input_pipeline_cli_on_the_cpu():
    """--device cpu at 0 and 2 threads: a line a thread count, the rate
    against --serving_fps, and a summary without a card."""
    proc = subprocess.run(
        [sys.executable, "-m", "shineon_tpu_torch.tools.input_pipeline", "--device", "cpu",
         "--workers", "0", "2", "--repeats", "1", "--serving_fps", "100",
         *(f"--{k}={v}" for k, v in SMALL.items())],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    rows = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["workers"] for r in rows[:2]] == [0, 2]
    for r in rows[:2]:
        assert r["frames_per_sec"] == pytest.approx(2 * 3 / (r["ms_per_batch"] / 1e3))
        assert r["vs_serving"] == pytest.approx(r["frames_per_sec"] / 100)
    assert rows[0]["batches"] == rows[2]["samples"] // 2 > 1
    assert rows[2]["card"] is None and rows[2]["device"] == "cpu"
