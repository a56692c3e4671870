"""The port's command line end to end on the CPU (``--gpu_ids -1``):
``shineon_tpu_torch.train.main`` trains, resumes and tests from a tiny
synthetic tree (tools/synthetic_data.py), the test entry refuses to run
without a checkpoint, and ``--accumulated_batches`` holds optax.MultiSteps'
semantics: against the JAX package's own accumulation test, against
``optax.MultiSteps(optax.adam)`` step for step, and across a checkpoint
taken between two updates."""

import glob
import os.path as osp
import subprocess
import sys

import numpy as np
import optax
import pytest
import torch

from shineon_tpu.training.optimizers import keep_decay_schedule as j_keep_decay_schedule
from shineon_tpu_torch import train
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.models.warp_model import WarpModel
from shineon_tpu_torch.options import TrainOptions, gmm_options, sams_options
from shineon_tpu_torch.serving import synthetic_raw_batch
from shineon_tpu_torch.tools.synthetic_data import make_viton_tree
from shineon_tpu_torch.training.checkpointing import load_checkpoint, save_checkpoint
from shineon_tpu_torch.training.optimizers import MultiSteps, make_optimizer
from shineon_tpu_torch.training.state import NetState, TrainState
from test_torch_training import TINY_TRAIN
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
# the GMM at its smallest fine size, ngf 8, f32, on the CPU, one batch
SMALL_GMM_ARGS = ["--model", "gmm", "--dataset", "viton", "--fine_height", "128",
                  "--fine_width", "96", "--ngf", "8", "--precision", "32", "--batch_size", "2",
                  "--workers", "0", "--gpu_ids", "-1", "--fast_dev_run"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    make_viton_tree(str(root / "viton"), n=4, height=128, width=96)
    make_viton_tree(str(root / "viton"), n=3, datamode="test", height=128, width=96)
    return root


def _params(state):
    return {name: [p.detach().clone() for p in net.module.parameters()]
            for name, net in state.nets.items()}


def test_train_resume_and_test_entries(tree):
    """train (fast_dev_run: one step, one validation, FINAL), then train
    again from FINAL (the step count carries on, the optimizers resume with
    the loader's steps an epoch), then test from the resumed run's FINAL:
    one warp-cloth image a test sample."""
    common = SMALL_GMM_ARGS + ["--viton_dataroot", str(tree / "viton"),
                               "--experiments_dir", str(tree / "exp")]
    state = train.main(True, common + ["--name", "first"])
    assert state.step == 1
    final = glob.glob(str(tree / "exp" / "first" / "checkpoints" / "named" / "FINAL_step=1"))
    assert final and osp.exists(osp.join(tree, "exp", "first", "checkpoints", "hparams.json"))

    resumed = train.main(True, common + ["--name", "second", "--checkpoint", final[0]])
    assert resumed.step == 2
    assert resumed.nets["gmm"].optimizer.schedule.steps_per_epoch == 2  # 4 samples, batch 2
    assert resumed.nets["gmm"].optimizer.count == 2
    final2 = str(tree / "exp" / "second" / "checkpoints" / "named" / "FINAL_step=2")
    assert osp.isdir(final2)

    tested = train.main(False, common + ["--name", "second", "--checkpoint", final2,
                                         "--result_dir", str(tree / "results"),
                                         "--data_list", "test_pairs.txt"])
    saved = torch.load(osp.join(final2, "state.pt"), weights_only=True)
    for k, v in tested.nets["gmm"].module.state_dict().items():
        assert torch.equal(v, saved["nets"]["gmm"]["module"][k]), k
    files = glob.glob(str(tree / "results" / "second" / "FINAL_step=2" / "test" / "**" /
                         "warp-cloth" / "*"), recursive=True)
    assert len(files) == 3


def test_test_module_refuses_without_checkpoint(tree):
    """``python -m shineon_tpu_torch.test`` without --checkpoint exits
    non-zero with the JAX package's message and writes nothing."""
    proc = subprocess.run(
        [sys.executable, "-m", "shineon_tpu_torch.test", *SMALL_GMM_ARGS, "--name", "refused",
         "--viton_dataroot", str(tree / "viton"), "--experiments_dir", str(tree / "exp")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "needs --checkpoint" in proc.stderr and "--allow_random_init" in proc.stderr
    assert not osp.exists(tree / "exp" / "refused")


def test_gpu_ids_pick_the_device():
    """The first of --gpu_ids is the CUDA device; -1 (no id) is the CPU;
    a CUDA device that is not there raises instead of running elsewhere."""
    parse = lambda ids: TrainOptions().parse(  # noqa: E731
        ["--model", "gmm", "--dataset", "viton", "--gpu_ids", ids])
    assert train.device_of(parse("-1")) == torch.device("cpu")
    if torch.cuda.is_available():
        assert train.device_of(parse("0,1")) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="--gpu_ids -1"):
            train.device_of(parse("0"))


def test_gradient_accumulation_matches_reference_semantics():
    """tests/test_train_e2e.py's semantics, on the port: with
    --accumulated_batches 2 the first step accumulates and leaves the GMM's
    parameters as they were, the second updates them."""
    opt = gmm_options(fine_height=128, fine_width=96, ngf=8, precision=32, batch_size=2,
                      accumulated_batches=2)
    model = WarpModel(opt, device="cpu")
    state = model.init_state(torch.Generator().manual_seed(9), 4)
    step = model.make_train_step()
    batch = synthetic_raw_batch(opt, 2, seed=1)
    p0 = _params(state)["gmm"]
    step(state, batch)
    p1 = _params(state)["gmm"]
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    step(state, batch)
    p2 = _params(state)["gmm"]
    assert max((a - b).abs().max().item() for a, b in zip(p1, p2)) > 0


def test_sams_accumulation_updates_every_kth_step():
    """All three SAMS optimizers accumulate: after the first of two
    mini-steps no network's parameters moved, after the second every
    network's did, and each Adam counts one update."""
    opt = sams_options(**TINY_TRAIN, batch_size=2, accumulated_batches=2)
    model = SamsModel(opt, device="cpu")
    state = model.init_state(torch.Generator().manual_seed(4), 4)
    step = model.make_train_step()
    batch = synthetic_raw_batch(opt, 2, seed=2)
    p0 = _params(state)
    step(state, batch)
    p1 = _params(state)
    for name in p0:
        assert all(torch.equal(a, b) for a, b in zip(p0[name], p1[name])), name
    step(state, batch)
    p2 = _params(state)
    for name, net in state.nets.items():
        assert isinstance(net.optimizer, MultiSteps)
        assert net.optimizer.inner.count == 1 and net.optimizer.mini_step == 0
        assert max((a - b).abs().max().item() for a, b in zip(p1[name], p2[name])) > 0, name


@pytest.mark.parametrize("k", [2, 3])
def test_multisteps_matches_optax(k):
    """MultiSteps(Adam) against optax.MultiSteps(optax.adam(schedule),
    every_k_schedule=k) over 6 mini-steps of seeded gradients, on the
    keep/decay schedule at one step an epoch (so the learning rate reads
    the inner update count): the parameters after every mini-step within
    a few f32 roundings (the running mean's division may round once more on
    either side), unchanged between updates, and the update count."""
    rng = np.random.RandomState(k)
    shapes = [(4, 3), (5,)]
    p0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes] for _ in range(6)]
    args = (1e-2, 1, 2, 1)  # lr, keep_epochs, decay_epochs, steps_per_epoch
    tx = optax.MultiSteps(optax.adam(learning_rate=j_keep_decay_schedule(*args)),
                          every_k_schedule=k)
    jp, js = [np.asarray(p) for p in p0], tx.init(p0)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    opt = make_optimizer(tp, args[0], *args[1:], accumulate=k)
    for i, g in enumerate(grads):
        updates, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, updates)
        before = [t.clone() for t in tp]
        opt.step([torch.from_numpy(a) for a in g])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)
        if (i + 1) % k:
            assert all(torch.equal(a, b) for a, b in zip(before, tp))
    assert opt.inner.count == 6 // k == int(js.gradient_step)


def test_mid_accumulation_checkpoint_resumes_exactly(tmp_path):
    """A train state saved between two updates (accumulation 3, after 4
    mini-steps) and loaded into a fresh state continues bit for bit like the
    state that was never saved."""
    def fresh():
        module = torch.nn.Linear(6, 4)
        with torch.no_grad():
            for i, p in enumerate(module.parameters()):
                p.copy_(torch.linspace(-1, 1, p.numel()).reshape(p.shape) * (i + 1))
        return TrainState(nets={"net": NetState(module, make_optimizer(
            module.parameters(), 1e-2, accumulate=3))})

    g = torch.Generator().manual_seed(0)
    grads = [[torch.randn(4, 6, generator=g), torch.randn(4, generator=g)] for _ in range(7)]
    a = fresh()
    for gr in grads[:4]:
        a.nets["net"].optimizer.step(gr)
    a.step = 4
    save_checkpoint(str(tmp_path / "mid"), a)
    b = load_checkpoint(str(tmp_path / "mid"), fresh())
    assert b.nets["net"].optimizer.mini_step == 1 and b.step == 4
    for state in (a, b):
        for gr in grads[4:]:
            state.nets["net"].optimizer.step(gr)
    for x, y in zip(a.nets["net"].module.parameters(), b.nets["net"].module.parameters()):
        assert torch.equal(x, y)
    assert a.nets["net"].optimizer.inner.count == b.nets["net"].optimizer.inner.count == 2
