"""The port's training runtime (shineon_tpu_torch.training.loop,
training.checkpointing, utils) against the JAX package on the CPU.

The slice as a whole: a GMM ``Trainer.fit`` (2 train steps, 1 validation,
``fast_dev_run`` off) from the JAX package's ``init_state(PRNGKey(420))``,
carried across with shineon_tpu_torch.convert and passed as
``resume_state`` to both trainers, on a tests/fixtures.py VITON tree at
128x96 (the GMM's smallest fine size), ngf 8, batch 2, f32; then
``Trainer.test``'s export. Also: checkpoint round trips and the keepers'
retention, ``hparams.json`` against the JAX keeper's, the board rows and
PNG export against shineon_tpu.utils.visualization, SSIM and PSNR against
shineon_tpu.utils.metrics, the option builders' runtime keys against the
JAX parsers, and what an interrupt or an exception saves."""

import glob
import json
import os
import os.path as osp
import signal

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import shineon_tpu.native as jnative
from fixtures import make_viton_fixture
from shineon_tpu.models.warp_model import WarpModel as JWarpModel
from shineon_tpu.options.base_options import namespace_from_defaults
from shineon_tpu.training.loop import Trainer as JTrainer
from shineon_tpu_torch import convert
from shineon_tpu_torch.models.warp_model import WarpModel
from shineon_tpu_torch.options import gmm_options, sams_options, tom_options
from shineon_tpu_torch.training.checkpointing import (
    CheckpointKeeper,
    load_checkpoint,
    load_hparams,
    save_checkpoint,
    state_to_host,
)
from shineon_tpu_torch.training.loop import Trainer, _pad_ragged_batch
from test_torch_networks import _np, one_torch_thread  # noqa: F401 (autouse)
from test_torch_training import TINY_TRAIN

SMALL_GMM = dict(fine_height=128, fine_width=96, ngf=8, precision=32, batch_size=2, workers=0)
LR = 1e-4


@pytest.fixture(scope="module")
def viton(tmp_path_factory):
    root = tmp_path_factory.mktemp("runtime")
    make_viton_fixture(str(root / "viton"), n=4)
    make_viton_fixture(str(root / "viton"), n=3, datamode="test")
    return root


def _gmm_opt(root, name, **kw):
    return gmm_options(**{**SMALL_GMM, **dict(
        viton_dataroot=str(root / "viton"), keep_epochs=1, decay_epochs=0,
        val_check_interval="2", limit_val_batches="1", display_count=1, name=name,
        experiments_dir=str(root / "exp"), result_dir=str(root / "results")), **kw})


def _state_snapshot(state):
    return {"step": state.step, "nets": {
        name: {"module": {k: v.clone() for k, v in net.module.state_dict().items()},
               "mu": [m.clone() for m in net.optimizer.mu],
               "nu": [v.clone() for v in net.optimizer.nu], "count": net.optimizer.count}
        for name, net in state.nets.items()}}


def assert_state_equals(payload, snapshot):
    """A checkpoint's raw dict against a snapshot of a state, bit for bit."""
    assert payload["step"] == snapshot["step"]
    assert sorted(payload["nets"]) == sorted(snapshot["nets"])
    for name, net in snapshot["nets"].items():
        saved = payload["nets"][name]
        assert sorted(saved["module"]) == sorted(net["module"])
        for k, v in net["module"].items():
            assert torch.equal(saved["module"][k], v), (name, k)
        for key in ("mu", "nu"):
            assert all(torch.equal(a, b) for a, b in zip(saved["optimizer"][key], net[key]))
        assert saved["optimizer"]["count"] == net["count"]


def _scalars(run_dir):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    events = EventAccumulator(osp.join(run_dir, "tb"))
    events.Reload()
    return {k: [(e.step, e.value) for e in events.Scalars(k)] for k in events.Tags()["scalars"]}


# ------------------------------------------------------ the slice against JAX

def test_gmm_fit_and_test_match_jax_trainer(viton, monkeypatch):
    """Both trainers fit the same GMM from the same state over the same
    batches (RandomState(420) order): 2 steps, scalars and images every
    step, one validation at step 2, FINAL. The logged losses agree: step 0
    within 1e-5 (the same state and batch), step 1 within 2e-3 (after one
    Adam step of each framework's gradient), the validation loss within
    1e-3. The GMM's grid gradient jumps where a sample point crosses a
    pixel edge, and the two frameworks' TPS grids differ by f32 rounding
    (ROADMAP.md §3, PR 8): at random weights Adam's first move, about lr
    sign(g), flips on about 1% of the entries, and the second move depends
    on the ratio of the two gradients. So the final parameters: every
    entry within 4 lr of the JAX package's (the most two moves of each can
    differ), at most 3% of them more than lr / 2 apart (1.8% here); a
    missing or reordered step moves nearly all of them by lr or more. The
    running statistics within 5e-2 of their largest entry (2.4e-2 here).
    Then Trainer.test exports the same PNG names, the pixels within a mean
    of 2 and a maximum of 32 levels (JPEG, the exports' format by their
    names)."""
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    jopt = _gmm_opt(viton, "jax")
    jmodel = JWarpModel(jopt)
    jstate = jmodel.init_state(jax.random.PRNGKey(420), 2)
    variables = {"params": _np(jstate.nets["gmm"].params), **_np(jstate.nets["gmm"].stats)}
    jfinal = JTrainer(jopt).fit(jmodel, jstate)

    opt = _gmm_opt(viton, "port")
    model = WarpModel(opt, device="cpu")
    convert.load_flax(model.gmm, variables, convert.GMM_RENAMES)
    trainer = Trainer(opt, device="cpu")
    final = trainer.fit(model, model.make_state(2))
    assert final.step == trainer.global_step == 2

    ref, out = _scalars(osp.join(jopt.experiments_dir, "jax")), _scalars(trainer.experiment_dir)
    assert sorted(out) == sorted(ref) == ["loss/G", "lr", "val_loss/G"]
    for key, tols in (("loss/G", (1e-5, 2e-3)), ("val_loss/G", (1e-3,)), ("lr", (1e-7, 1e-7))):
        assert [s for s, _ in out[key]] == [s for s, _ in ref[key]], key
        for (_, a), (_, b), tol in zip(out[key], ref[key], tols):
            assert abs(a - b) <= tol * abs(b), (key, a, b)

    init = {k: v.numpy() for k, v in convert.flax_to_state_dict(
        variables, convert.GMM_RENAMES).items()}
    jsd = {k: v.numpy() for k, v in convert.flax_to_state_dict(
        {"params": _np(jfinal.nets["gmm"].params), **_np(jfinal.nets["gmm"].stats)},
        convert.GMM_RENAMES).items()}
    mine = {k: v.numpy() for k, v in model.gmm.state_dict().items()}
    assert sorted(mine) == sorted(jsd)
    apart = total = 0
    for key, r in jsd.items():
        if key.endswith(("running_mean", "running_var")):
            assert np.abs(mine[key] - r).max() <= 5e-2 * np.abs(r).max(), key
            continue
        diff = np.abs(mine[key] - r)
        assert diff.max() <= 4 * LR + 2.4e-7 * np.abs(init[key]).max(), key
        assert not np.array_equal(mine[key], init[key]), key
        apart += int((diff > LR / 2).sum())
        total += r.size
    assert apart <= 0.03 * total, (apart, total)

    exports = {}
    for tag, (m, state, trainer_cls) in {"jax": (jmodel, jfinal, JTrainer),
                                         "port": (model, final, Trainer)}.items():
        topt = _gmm_opt(viton, tag, is_train=False, data_list="test_pairs.txt")
        m.override_hparams(topt)
        (trainer_cls(topt) if tag == "jax" else trainer_cls(topt, device="cpu")).test(m, state)
        base = osp.join(topt.result_dir, tag)
        exports[tag] = {osp.relpath(p, base) for p in glob.glob(f"{base}/**/*.jpg",
                                                                recursive=True)}
    assert exports["port"] == exports["jax"] and len(exports["jax"]) == 6  # 3 cloths, 3 masks
    for rel in exports["jax"]:
        a, b = (np.asarray(Image.open(osp.join(viton, "results", tag, rel)), np.int16)
                for tag in ("jax", "port"))
        assert np.abs(a - b).mean() <= 2 and np.abs(a - b).max() <= 32, rel


# ------------------------------------------------------------- checkpoints

def test_checkpoint_round_trip_bit_for_bit(tmp_path):
    """A trained GMM state (batch statistics, Adam's moments after a step)
    and a SAMS state (spectral u and sigma, three networks, moments drawn
    at random) load with weights_only=True: without a template the raw
    dict, and into the model's own state after every tensor of it was
    overwritten, in place: every parameter, buffer, moment and count, and
    the step, bit for bit."""
    from shineon_tpu_torch.bench import build_train

    _, state, step, raw, _ = build_train(2, device="cpu", model="warp",
                                         **{k: v for k, v in SMALL_GMM.items()
                                            if k not in ("batch_size", "workers")})
    step(state, raw)
    _, sams_state, *_ = build_train(2, device="cpu", **TINY_TRAIN)
    g = torch.Generator().manual_seed(1)
    for net in sams_state.nets.values():
        for m in net.optimizer.mu + net.optimizer.nu:
            m.copy_(torch.rand(m.shape, generator=g))
        net.optimizer.count = 7
    sams_state.step = 7
    for tag, st in (("gmm", state), ("sams", sams_state)):
        snapshot = _state_snapshot(st)
        path = save_checkpoint(str(tmp_path / tag), st)
        payload = torch.load(osp.join(path, "state.pt"), weights_only=True)
        assert_state_equals(payload, snapshot)
        assert_state_equals(load_checkpoint(path), snapshot)
        tensors = {id(t): t for net in st.nets.values() for t in (
            *net.module.state_dict().values(), *net.optimizer.mu, *net.optimizer.nu)}
        with torch.no_grad():
            for t in tensors.values():
                t.copy_(torch.rand(t.shape, generator=g).to(t.dtype))
        for net in st.nets.values():
            net.optimizer.count = 0
        st.step = 0
        with pytest.raises(AssertionError):  # the state differs before the load
            assert_state_equals(state_to_host(st), snapshot)
        params = [p for net in st.nets.values() for p in net.optimizer.params]
        assert load_checkpoint(path, st) is st
        assert all(a is b for a, b in zip(params, [p for net in st.nets.values()
                                                   for p in net.optimizer.params]))
        assert_state_equals(state_to_host(st), snapshot)
        if tag == "sams":
            assert any(k.endswith(".u") for k in snapshot["nets"]["generator"]["module"])


def test_keeper_retention_and_layout(tmp_path):
    """Top-k keeps the 5 lowest checkpoint_on (an earlier save wins a tie),
    the step saves the 3 latest every save_count steps; named saves
    replace; a new keeper over the directory takes its saves up; the
    hparams are found walking up from a checkpoint."""
    model = WarpModel(gmm_options(**{k: v for k, v in SMALL_GMM.items() if k != "workers"}),
                      device="cpu")
    state = model.make_state(1)
    keeper = CheckpointKeeper(str(tmp_path / "checkpoints"), save_count=2)
    values = [5.0, 3.0, 7.0, 1.0, 4.0, 9.0, 2.0, 4.0, 4.0]
    kept = [keeper.save_validation(step, state, v) for step, v in enumerate(values, start=1)]
    assert kept == [True] * 5 + [False, True, True, False]
    assert sorted(int(d) for d in os.listdir(tmp_path / "checkpoints" / "topk")) == [2, 4, 5, 7, 8]
    for step in range(1, 10):
        keeper.maybe_save_step(step, state)
    assert sorted(int(d) for d in os.listdir(tmp_path / "checkpoints" / "steps")) == [4, 6, 8]
    keeper.save_final(state, 9)
    keeper.save_named("interrupted_by_Ctrl-C", state)
    keeper.save_named("interrupted_by_Ctrl-C", state)
    assert sorted(os.listdir(tmp_path / "checkpoints" / "named")) == [
        "FINAL_step=9", "interrupted_by_Ctrl-C"]
    again = CheckpointKeeper(str(tmp_path / "checkpoints"), save_count=2)
    assert again.save_validation(10, state, 4.5) is False
    assert again.save_validation(11, state, 0.5) is True
    assert sorted(int(d) for d in os.listdir(tmp_path / "checkpoints" / "topk")) == [2, 4, 5, 7, 11]
    keeper.write_hparams(gmm_options(name="kept"))
    assert load_hparams(str(tmp_path / "checkpoints" / "steps" / "8"))["name"] == "kept"


def test_hparams_json_matches_jax_keeper(tmp_path):
    """hparams.json holds the same bytes as the JAX keeper's for the same
    namespace (lists, None, tuples, a value json cannot hold)."""
    from shineon_tpu.training.checkpointing import CheckpointKeeper as JKeeper

    opt = sams_options(name="hp", attention_middle_indices=("-1",))
    opt.odd = {1, 2}
    JKeeper(str(tmp_path / "jax")).write_hparams(opt)
    CheckpointKeeper(str(tmp_path / "port")).write_hparams(opt)
    ref = (tmp_path / "jax" / "hparams.json").read_bytes()
    assert (tmp_path / "port" / "hparams.json").read_bytes() == ref
    assert json.loads(ref)["odd"] == "{1, 2}"


# ------------------------------------------------------- visuals, metrics

class Board:
    def __init__(self):
        self.images = []

    def add_image(self, tag, img, step, dataformats):
        self.images.append((tag, np.array(img), step, dataformats))


def test_board_rows_and_png_export_match_jax(tmp_path):
    """The board canvas and its add_image calls, and the PNG bytes of
    save_images (one- and three-channel, skip-if-exists, the warp-mask rule),
    equal shineon_tpu.utils.visualization's."""
    from shineon_tpu.utils import visualization as jvis

    from shineon_tpu_torch.utils import visualization as vis

    rng = np.random.RandomState(0)
    rows = [[rng.uniform(-1.2, 1.2, (2, 8, 6, 3)).astype(np.float32),
             rng.uniform(-1, 1, (2, 8, 6, 1)).astype(np.float32)],
            [rng.uniform(-1, 1, (2, 8, 6, 3)).astype(np.float32)]]
    np.testing.assert_array_equal(vis.tensor_list_for_board(rows), jvis.tensor_list_for_board(rows))
    a, b = Board(), Board()
    vis.board_add_images(a, "train", rows, 3)
    jvis.board_add_images(b, "train", rows, 3)
    assert [x[0] for x in a.images] == [x[0] for x in b.images] == ["train/000", "train/001"]
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x[1], y[1])
        assert x[2:] == y[2:]
    imgs = rng.uniform(-1, 1, (2, 8, 6, 3)).astype(np.float32)
    masks = rng.uniform(-1, 1, (2, 8, 6, 1)).astype(np.float32)
    names = ["v/a.png", "v/b.png"]
    for tag, module in (("port", vis), ("jax", jvis)):
        root = tmp_path / tag
        module.save_images(imgs, names, str(root / "VitonDataset" / "warp-cloth"))
        module.save_images(masks, names, [str(root / "VitonDataset" / "warp-mask")])
        module.save_images(masks, names, str(root / "VVTDataset" / "warp-mask"))
        module.save_images(imgs * 0, names[:1], str(root / "VitonDataset" / "warp-cloth"))
    files = sorted(osp.relpath(p, tmp_path / "jax") for p in glob.glob(
        str(tmp_path / "jax" / "**" / "*.png"), recursive=True))
    assert len(files) == 4
    assert files == sorted(osp.relpath(p, tmp_path / "port") for p in glob.glob(
        str(tmp_path / "port" / "**" / "*.png"), recursive=True))
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


@pytest.mark.parametrize("channels", [1, 3])
def test_ssim_psnr_match_jax(channels):
    from shineon_tpu.utils import metrics as jmetrics

    from shineon_tpu_torch.utils import metrics

    rng = np.random.RandomState(channels)
    a = rng.randint(0, 256, (24, 20, channels)).astype(np.uint8)
    b = np.clip(a.astype(int) + rng.randint(-30, 31, a.shape), 0, 255).astype(np.uint8)
    if channels == 1:
        a, b = a[..., 0], b[..., 0]
    for kw in ({}, {"data_range": 255.0}):
        assert metrics.structural_similarity(a, b, multichannel=channels == 3, **kw) == \
            jmetrics.structural_similarity(a, b, multichannel=channels == 3, **kw)
        assert metrics.peak_signal_noise_ratio(a, b, **kw) == \
            jmetrics.peak_signal_noise_ratio(a, b, **kw)
    assert metrics.peak_signal_noise_ratio(a, a) == float("inf")


def test_utils_match_jax():
    """str2num, find_class_in_module and get_prev_data_zero_bounded against
    shineon_tpu.utils."""
    from shineon_tpu import utils as jutils

    from shineon_tpu_torch import utils

    for s in ("4", "0.125", "1.0", 3, 0.5):
        assert utils.str2num(s) == jutils.str2num(s)
        assert type(utils.str2num(s)) is type(jutils.str2num(s))
    assert utils.find_class_in_module("viton_dataset", "shineon_tpu_torch.datasets.viton_dataset") \
        .__name__ == "VitonDataset"
    with pytest.raises(ImportError):
        utils.find_class_in_module("nothing", "shineon_tpu_torch.utils")
    data = list(range(6))
    for end, n in ((0, 3), (2, 3), (5, 3), (5, 1), (1, 4)):
        assert utils.get_prev_data_zero_bounded(data, end, n) == \
            list(jutils.get_prev_data_zero_bounded(data, end, n))


# ----------------------------------------------------------------- options

@pytest.mark.parametrize("model,dataset,builder", [
    ("warp", "viton", gmm_options), ("unet_mask", "vvt", tom_options),
    ("sams", "vvt", sams_options), ("warp", "mpv", gmm_options)],
    ids=["gmm-viton", "tom-vvt", "sams-vvt", "gmm-mpv"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "test"])
def test_runtime_options_match_jax_parsers(model, dataset, builder, is_train):
    """The dataset and runtime keys of the builders have the defaults the
    JAX parsers give them, at train and at test; the val_check_interval
    clamp and fast_dev_run as base_options.py applies them."""
    ref = namespace_from_defaults(model, dataset, is_train=is_train)
    opt = builder(dataset=dataset, is_train=is_train)
    assert opt.name == "unnamed_experiment"  # namespace_from_defaults passes --name test
    keys = ["experiments_dir", "checkpoint", "workers", "limit_train_batches",
            "limit_val_batches", "display_count", "fast_dev_run", "no_shuffle", "datamode",
            "val_fraction"]
    keys += {"viton": ["viton_dataroot", "data_list"], "vvt": ["vvt_dataroot", "warp_cloth_dir"],
             "mpv": ["mpv_dataroot"]}[dataset]
    if dataset == "vvt" and model != "sams":  # SAMS's production clip is 5 frames
        keys.append("n_frames_now")
    keys += ["save_count", "val_check_interval"] if is_train else [
        "result_dir", "tryon_list", "random_tryon"]
    for key in keys:
        assert getattr(opt, key) == getattr(ref, key), key
    if is_train:
        clamp = dict(limit_train_batches="4", val_check_interval="10")
        assert builder(**clamp).val_check_interval == namespace_from_defaults(
            model, dataset, **clamp).val_check_interval == "4"
        assert builder(fast_dev_run=True).val_check_interval == 1


# ------------------------------------------------------- the runtime's rules

def test_trainer_runs_on_the_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(gmm_options(experiments_dir="/nonexistent"))


def test_trace_dir_traces_a_window_of_steps(viton, monkeypatch, tmp_path):
    """With SHINEON_TRACE_DIR set, fit writes a torch.profiler trace of the
    steps TRACE_STEPS names (8 to 12; here 1 to 2, to keep the test short), a
    chrome trace holding their ops, and trains on."""
    from shineon_tpu_torch.training import loop

    assert loop.TRACE_STEPS == (8, 12)
    monkeypatch.setattr(loop, "TRACE_STEPS", (1, 2))
    monkeypatch.setenv("SHINEON_TRACE_DIR", str(tmp_path / "trace"))
    opt = _gmm_opt(viton, "traced", keep_epochs=2, val_check_interval="100",
                   display_count=100)
    model = WarpModel(opt, device="cpu")
    trainer = Trainer(opt, device="cpu")
    trainer.fit(model)
    assert trainer.global_step == 4
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)


def test_pad_ragged_batch():
    batch = {"a": np.arange(6).reshape(3, 2), "names": ["x", "y", "z"], "s": np.float32(1)}
    out = _pad_ragged_batch(batch, 5)
    np.testing.assert_array_equal(out["a"], [[0, 1], [2, 3], [4, 5], [4, 5], [4, 5]])
    assert out["names"] == ["x", "y", "z"] and out["s"] == 1


class Recorder:
    """Wraps a model's train step: snapshots of the state after each step,
    and optionally a failure at a given call."""

    def __init__(self, model, fail_at=None, fail=None):
        self.snapshots, self.calls = [], 0
        make = model.make_train_step

        def make_train_step():
            step = make()

            def recorded(state, batch):
                self.calls += 1
                if self.calls == fail_at:
                    fail(state, batch, step)
                metrics = step(state, batch)
                self.snapshots.append(_state_snapshot(state))
                return metrics

            return recorded

        model.make_train_step = make_train_step


def _interrupt_opt(root, name):
    return _gmm_opt(root, name, keep_epochs=3, val_check_interval="100", display_count=100,
                    limit_val_batches="1")


def _interrupt_path(opt, name):
    return osp.join(opt.experiments_dir, opt.name, "checkpoints", "named", name)


def test_loader_exception_saves_last_completed_step(viton, monkeypatch):
    """The loader raises when asked for the third batch: the exception
    propagates, and interrupted_by_<its class> holds the state after the
    second step, bit for bit."""
    from shineon_tpu_torch.datasets import loader

    opt = _interrupt_opt(viton, "loader_raise")
    model = WarpModel(opt, device="cpu")
    rec = Recorder(model)
    real_iter = loader.DataLoader.__iter__

    def failing_iter(self):
        for i, batch in enumerate(real_iter(self)):
            if i == 0 and len(rec.snapshots) == 2:
                raise OSError("the disk went away")
            yield batch

    monkeypatch.setattr(loader.DataLoader, "__iter__", failing_iter)
    with pytest.raises(OSError, match="disk went away"):
        Trainer(opt, device="cpu").fit(model)
    assert len(rec.snapshots) == 2
    assert_state_equals(load_checkpoint(_interrupt_path(opt, "interrupted_by_OSError")),
                        rec.snapshots[-1])


def test_exception_before_first_update_saves_state_as_it_stood(viton):
    """A step that raises before its first update (in the device features)
    leaves the state as the previous step left it, and that state is
    saved."""
    opt = _interrupt_opt(viton, "step_raise")
    model = WarpModel(opt, device="cpu")

    def fail(state, batch, step):
        raise ValueError("bad batch")

    rec = Recorder(model, fail_at=3, fail=fail)
    with pytest.raises(ValueError, match="bad batch"):
        Trainer(opt, device="cpu").fit(model)
    assert_state_equals(load_checkpoint(_interrupt_path(opt, "interrupted_by_ValueError")),
                        rec.snapshots[-1])


def test_exception_after_partial_update_saves_nothing(viton):
    """A step that raises after it has updated part of the state (here the
    running statistics of its forward) saves no interrupt checkpoint."""
    opt = _interrupt_opt(viton, "torn")
    model = WarpModel(opt, device="cpu")

    def fail(state, batch, step):
        model.forward_loss(model.features(batch), train=True)  # updates the running stats
        raise ValueError("after the forward")

    Recorder(model, fail_at=2, fail=fail)
    with pytest.raises(ValueError, match="after the forward"):
        Trainer(opt, device="cpu").fit(model)
    assert not osp.exists(_interrupt_path(opt, "interrupted_by_ValueError"))


def test_sigint_saves_at_the_step_boundary(viton):
    """A SIGINT in the middle of the second step: the step completes, the
    loop saves interrupted_by_Ctrl-C with the state after it and exits with
    1; the previous SIGINT handler is back afterwards."""
    opt = _interrupt_opt(viton, "sigint")
    model = WarpModel(opt, device="cpu")

    def fail(state, batch, step):
        signal.raise_signal(signal.SIGINT)

    rec = Recorder(model, fail_at=2, fail=fail)
    before = signal.getsignal(signal.SIGINT)
    with pytest.raises(SystemExit) as info:
        Trainer(opt, device="cpu").fit(model)
    assert info.value.code == 1 and len(rec.snapshots) == 2
    assert_state_equals(load_checkpoint(_interrupt_path(opt, "interrupted_by_Ctrl-C")),
                        rec.snapshots[-1])
    assert signal.getsignal(signal.SIGINT) is before
