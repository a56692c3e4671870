"""Build and load the hand-written CUDA kernels of ``shineon_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into a shared library under
``shineon_tpu_torch/_build/`` (listed in .gitignore) the first time it is
needed, and loaded with ``ctypes``. The library's file name carries a hash
of its source and of the shared headers (``csrc/*.cuh``), so an edited
source is rebuilt and a stale build is never loaded. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from shineon_tpu_torch import tracing

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """The build of ``csrc/<name>.cu``, named by a hash of the source and of
    the headers of ``csrc`` it may include."""
    digest = hashlib.sha1()
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a current build exists. Returns the
    ptxas report (registers, shared memory, spills), kept beside the build;
    raises on failure."""
    out = library_path(name)
    report = out.with_suffix(".ptxas.txt")
    if out.exists():
        return report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name} (nvcc exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    report.write_text(proc.stdout)
    os.replace(tmp, out)
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed;
    the build and load a set-up span, ``setup.kernel_load``."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            with tracing.setup("setup.kernel_load"):
                build(name)
                lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
