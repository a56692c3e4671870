"""Data parallelism (shineon_tpu_torch.parallel.ddp, the counterpart of
shineon_tpu/parallel/mesh.py) on the CPU with gloo, torch only: two ranks
with a local batch of 2 against one process on the global batch of 4; a
group of one against no group; the loader's striding; and the command
line's entry as torchrun starts it."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shineon_tpu_torch.datasets.loader import DataLoader
from shineon_tpu_torch.parallel import ddp
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)
from torch_ddp_worker import norm_gradients

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_ddp_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ranks(kind, world, tmp_path, tag):
    """Run ``world`` ranks (0: one process without a group) at once; their
    saved results in rank order."""
    init = f"tcp://localhost:{_free_port()}"
    outs = [tmp_path / f"{tag}{r}.pt" for r in range(max(world, 1))]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, str(WORKER), kind, str(r), str(world), init,
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r, out in enumerate(outs)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log[-3000:]
    return [torch.load(out, weights_only=True) for out in outs]


def _equal(a, b):
    return sorted(a) == sorted(b) and all(
        torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k] for k, v in a.items())


@pytest.fixture(scope="module")
def sams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    return {"two": _ranks("sams", 2, tmp, "two"), "one": _ranks("sams", 1, tmp, "one")[0],
            "bare": _ranks("sams", 0, tmp, "bare")[0]}


def test_two_ranks_hold_one_state(sams):
    """After an exact SAMS step the ranks' states (parameters, running
    statistics, spectral u and sigma, both Adam moments) are bit for bit
    the same; their losses are their own halves'."""
    r0, r1 = sams["two"]
    assert _equal(r0["state"], r1["state"])
    assert r0["metrics"]["loss"] != r1["metrics"]["loss"]


def test_two_ranks_match_the_global_batch(sams):
    """The two ranks against one process on the global batch: the step's
    losses (generator losses before any update, the discriminators' after
    the generator's) averaged over the ranks within 1e-5 (8e-8 and 6.5e-7
    measured); every parameter within two Adam moves, 2 lr, of the global
    one and at most 0.5% of the entries more than lr / 10 apart (0.03%:
    Adam's first move is lr sign(g), and a bias before a batch norm has a
    gradient of f32 noise); the running statistics and spectral state
    within 1e-3 of their largest entry (4.4e-4: the regeneration runs the
    updated generator)."""
    (r0, r1), ref = sams["two"], sams["bare"]
    for key, value in ref["metrics"].items():
        mean = (r0["metrics"][key] + r1["metrics"][key]) / 2
        assert abs(mean - value) <= 1e-5 * max(abs(value), 1.0), (key, mean, value)
    lr = {"generator": 1e-4, "d_multi": 3e-4, "d_temporal": 3e-4}
    far = total = 0
    for key, value in ref["state"].items():
        if not isinstance(value, torch.Tensor) or ".mu." in key or ".nu." in key:
            continue
        d = (r0["state"][key] - value).abs()
        if key.endswith(("running_mean", "running_var", ".u", ".sigma")):
            assert float(d.max()) <= 1e-3 * float(value.abs().max()), key
            continue
        net_lr = lr[key.split(".")[0]]
        assert float(d.max()) <= 2 * net_lr + 1e-6, key
        far, total = far + int((d > net_lr / 10).sum()), total + d.numel()
    assert far <= 0.005 * total, (far, total)


def test_group_of_one_is_the_bare_step(sams):
    """A group of one rank (gloo) all-reduces each gradient and divides it
    by 1, and keeps the local statistics: the step is the bare step bit
    for bit."""
    assert sams["one"]["metrics"] == sams["bare"]["metrics"]
    assert _equal(sams["one"]["state"], sams["bare"]["state"])


def test_global_statistics_gradient(tmp_path):
    """Through a train-mode SyncBatchNorm on the global statistics, the
    gradients two ranks take (the parameters' averaged, and each rank's
    inputs' over the world size: the global loss is the mean of the ranks')
    equal one process's on the global batch within 1e-5 (the conv bias's
    gradient, f32 noise, within 1e-6 of the largest), and so do the running
    statistics; with each half's own statistics the parameters'
    gradients differ by more than 1%."""
    ranks = _ranks("norm", 2, tmp_path, "norm")
    ref = norm_gradients(0, 4)
    # the dense bias's gradient is f32 noise (the norm removes a shift): an
    # absolute tolerance at the scale of the largest parameter gradient
    scale = max(float(g.abs().max()) for g in ref["grads"][:4])
    for i, g in enumerate(ref["grads"][:4]):
        for r in ranks:
            np.testing.assert_allclose(r["grads"][i], g, rtol=1e-5, atol=1e-6 * scale)
    x_grad = torch.cat([r["grads"][4] for r in ranks]) / 2
    np.testing.assert_allclose(x_grad, ref["grads"][4], rtol=1e-5,
                               atol=1e-6 * float(ref["grads"][4].abs().max()))
    for r in ranks:
        for a, b in zip(r["stats"], ref["stats"]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    local = [norm_gradients(r, 2) for r in range(2)]
    g_local = (local[0]["grads"][0] + local[1]["grads"][0]) / 2
    assert float((g_local - ref["grads"][0]).abs().max()) > 1e-2 * float(
        ref["grads"][0].abs().max())


def test_loader_strides_by_rank():
    """Each rank loads batch_size samples a step; together the ranks' step
    batches are the global order's, strided as the JAX loader strides by
    process (RandomState(seed + epoch), padded by wrapping)."""
    data = list(range(11))
    world = [DataLoader(data, batch_size=2, process_index=r, process_count=2)
             for r in range(2)]
    order = np.arange(11)
    np.random.RandomState(420).shuffle(order)
    order = np.concatenate([order, order[:1]])
    batches = [loader.batch_indices() for loader in world]
    assert [len(b) for b in batches] == [3, 3] and all(len(x) == 2 for b in batches for x in b)
    for r in range(2):
        np.testing.assert_array_equal(np.concatenate(batches[r]), order[r::2][:6])


def test_launched_reads_torchrun_environment(monkeypatch):
    from argparse import Namespace

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert not ddp.launched(Namespace(distributed_backend="ddp"))
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert ddp.launched(Namespace(distributed_backend="ddp"))
    assert not ddp.launched(Namespace(distributed_backend="dp"))
    assert ddp.world_size() == 1 and ddp.rank() == 0 and not ddp.active()
    grads = [torch.ones(2)]
    assert ddp.average_gradients(grads)[0] is grads[0]


def test_train_entry_under_torchrun_environment(tmp_path, monkeypatch):
    """``python -m shineon_tpu_torch.train --distributed_backend ddp`` as
    torchrun starts one rank of one (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT): it joins a gloo group on the CPU, trains a fast_dev_run
    GMM step, writes its checkpoint as rank 0 and leaves the group."""
    from shineon_tpu_torch import train as entry
    from shineon_tpu_torch.tools.synthetic_data import make_viton_tree

    make_viton_tree(str(tmp_path / "viton"), n=4, height=128, width=96)
    for key, value in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                           MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(key, value)
    state = entry.main(True, ["--model", "gmm", "--dataset", "viton", "--viton_dataroot",
                              str(tmp_path / "viton"), "--gpu_ids", "-1", "--fine_height", "128",
                              "--fine_width", "96", "--ngf", "8", "--batch_size", "2",
                              "--workers", "0", "--precision", "32", "--fast_dev_run",
                              "--experiments_dir", str(tmp_path / "exp"), "--name", "ddp",
                              "--distributed_backend", "ddp"])
    assert state.step == 1 and not ddp.active()
    assert (tmp_path / "exp" / "ddp" / "checkpoints" / "named" / "FINAL_step=1" /
            "state.pt").exists()
