"""The port stands alone: no module of shineon_tpu_torch, and not
chip_smoke.py, imports JAX, flax or the JAX package, nor the repository's
own root modules (the JAX tools package ``tools``, the tests' ``fixtures``,
the root scripts): an absolute import whose first name is one of them is
refused, so ``shineon_tpu_torch.tools`` stays allowed. Its entry points do
not quietly fall back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "shineon_tpu",
             # the repository's root package and modules
             "tools", "fixtures", "bench", "calculate_metrics", "plot_all_videos",
             "convert_folders_to_animated", "train", "test", "__graft_entry__")


def _port_sources():
    files = sorted((REPO / "shineon_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_sources_exist():
    files = _port_sources()
    assert len(files) > 10
    assert all(f.exists() for f in files)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_import(path):
    bad = sorted({root for root in _imported_roots(path) if root in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_build_inference_default_device_raises_without_cuda():
    """With no device argument the clip runs on the card; on a host without
    CUDA that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from shineon_tpu_torch.serving import build_inference

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_inference(batch_size=1)


def test_chain_sites_exits_without_cuda():
    """The chain timing tool, run by path as its users run it, exits 1 and
    times nothing on a host without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    tool = REPO / "shineon_tpu_torch" / "tools" / "chain_sites.py"
    proc = subprocess.run([sys.executable, str(tool), "--tag", "cpu"], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device" in proc.stderr
    assert "site" not in proc.stdout


def test_root_module_imports_are_refused(tmp_path):
    """The check sees the repository's root modules by their first name and
    leaves the port's own ``tools`` package and relative imports alone."""
    src = tmp_path / "probe.py"
    src.write_text("import fixtures\nfrom tools.e2e_quality import run_e2e\nimport test\n"
                   "from shineon_tpu_torch.tools import e2e_quality\nfrom . import train\n"
                   "from .tools import quality_curve\n")
    assert sorted(r for r in _imported_roots(src) if r in FORBIDDEN) == [
        "fixtures", "test", "tools"]
