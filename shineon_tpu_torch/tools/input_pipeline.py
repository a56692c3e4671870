"""Host input-pipeline scaling: the VVT dataset and the port's DataLoader
against the serving rate (counterpart of tools/bench_input_pipeline.py).

    python3 -m shineon_tpu_torch.tools.input_pipeline [--workers 1 2 4 8]
        [--videos 4] [--frames 24] [--batch 16] [--repeats 3]
        [--serving_fps F] [--device cpu]

Writes a synthetic VVT tree at 256x192 (``tools/synthetic_data.py::
make_vvt_tree``) into a temporary directory, then reads it with
``datasets/loader.py::DataLoader`` (PIL decode in ``--workers`` threads,
crop, per-frame feature assembly, collate) and moves each batch's arrays
to the device, as the trainer does: what the card is fed. For each thread
count, after a warm epoch (page cache, lazy inits), the best of
``--repeats`` epochs in ms a batch and frames/s (batch x n_frames
frames a batch). With ``--serving_fps`` (serving_stages.py's
``clip_fps``) each rate is also given as a share of it, the comparison
the JAX tool's docstring makes. Prints one JSON line a thread count and a
summary line with the card's nvidia-smi line. Runs on the card;
``--device cpu`` keeps the batches on the host.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import tempfile
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from shineon_tpu_torch.datasets import find_dataset_using_name
from shineon_tpu_torch.datasets.loader import DataLoader
from shineon_tpu_torch.options import sams_options
from shineon_tpu_torch.tools import card_line, device_or_exit, sync
from shineon_tpu_torch.tools.synthetic_data import make_vvt_tree

WORKERS = (1, 2, 4, 8)


def build_dataset(root: str, videos: int = 4, frames: int = 24, n_frames: int = 5,
                  height: int = 256, width: int = 192, batch: int = 16):
    """Write a synthetic VVT tree under ``root`` and open it as the VVT
    dataset of ``n_frames``-frame clips."""
    data_root = osp.join(root, "vvt")
    make_vvt_tree(data_root, n_videos=videos, frames=frames, datamode="train", seed=0,
                  height=height, width=width)
    opt = sams_options(vvt_dataroot=data_root, fine_height=height, fine_width=width,
                       n_frames_total=n_frames, n_frames_now=n_frames, batch_size=batch)
    return find_dataset_using_name("vvt")(opt)


def make_loader(dataset, batch: int, workers: int) -> DataLoader:
    """The JAX tool's loader: shuffled, ``workers`` decode threads, ragged
    last batch dropped, one process."""
    return DataLoader(dataset, batch_size=batch, shuffle=True, workers=workers, drop_last=True,
                      process_index=0, process_count=1)


def device_batches(loader: DataLoader, device) -> Iterator[Dict]:
    """The loader's batches with every numeric array moved to ``device``."""
    for batch in loader:
        yield {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
               and v.dtype.kind in "biuf" else v for k, v in batch.items()}


def time_loader(loader: DataLoader, device, repeats: int = 3) -> float:
    """Seconds a batch: the best of ``repeats`` epochs after a warm one,
    each to a synchronize."""
    for _ in device_batches(loader, device):
        pass
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        n = sum(1 for _ in device_batches(loader, device))
        sync(device)
        best = min(best, (time.perf_counter() - t0) / max(n, 1))
    return best


def run(workers: Sequence[int] = WORKERS, videos: int = 4, frames: int = 24, batch: int = 16,
        n_frames: int = 5, height: int = 256, width: int = 192, repeats: int = 3,
        serving_fps: Optional[float] = None, device="cuda") -> dict:
    """Each thread count's ms a batch and frames/s: {"rows": [...],
    summary fields}."""
    device = torch.device(device)
    rows = []
    with tempfile.TemporaryDirectory(prefix="shineon_pipe_") as root:
        dataset = build_dataset(root, videos, frames, n_frames, height, width, batch)
        for w in workers:
            loader = make_loader(dataset, batch, w)
            s = time_loader(loader, device, repeats)
            fps = batch * n_frames / s
            rows.append({"workers": w, "ms_per_batch": s * 1e3, "frames_per_sec": fps,
                         "batches": len(loader),
                         "vs_serving": None if serving_fps is None else fps / serving_fps})
    return {"rows": rows, "samples": len(dataset), "batch": batch, "n_frames": n_frames,
            "frame": [height, width], "repeats": repeats, "serving_fps": serving_fps,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
            "card": card_line() if device.type == "cuda" else None}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--videos", type=int, default=4)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--n_frames", type=int, default=5)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--width", type=int, default=192)
    p.add_argument("--workers", type=int, nargs="*", default=list(WORKERS))
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--serving_fps", type=float, default=None,
                   help="the serving rate to compare with (serving_stages.py's clip_fps)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = device_or_exit(args.device, "input_pipeline")
    out = run(args.workers, args.videos, args.frames, args.batch, args.n_frames, args.height,
              args.width, args.repeats, args.serving_fps, device)
    for row in out.pop("rows"):
        print(json.dumps(row), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
