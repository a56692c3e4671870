"""The train and test loop (counterpart of shineon_tpu/training/loop.py;
the Lightning Trainer of the reference, train.py:52-141):

  * ``fit``: ``keep_epochs + decay_epochs`` epochs of train steps;
    validation every ``val_check_interval`` (an int counts batches, a float
    is a fraction of an epoch) with top-k checkpoints on its mean
    ``checkpoint_on``; every ``display_count`` steps the step's scalars and
    the board's image rows, the only steps whose metrics are read back;
    every ``save_count`` steps a checkpoint; FINAL at the end;
  * ``fast_dev_run``: one train batch and one validation batch, validation
    every step; the loaders' limits are the options' ``limit_*_batches``;
  * a SIGINT or an exception saves ``interrupted_by_<Name>`` (below);
  * a per-step summary of the host's time in each step call
    (``_report_profile``, the reference's ``profiler=True``); with
    ``SHINEON_TRACE_DIR`` set, a torch.profiler trace of steps 8 to 12.

The port's steps update the train state in place, where the JAX step
returns a new one. So an interrupt or an exception must not save a state
that a step left half updated. A SIGINT sets a flag, and the loop saves
``interrupted_by_Ctrl-C`` at the next step boundary, then exits with 1. An
exception saves ``interrupted_by_<its class>`` if no tensor of the state
changed since the last completed step (every tensor's version counter is
read before each step), which holds for an exception in the loader, in
validation or before a step's first update; after a partial update it
saves nothing, says so and re-raises. Each save copies the state to the
host before the next step runs.

A resumed ``fit`` restarts at epoch 0 with ``global_step`` from the state's
step, as the JAX package's does (loop.py:98-99,124). Runs on the card
unless the trainer is made with ``device="cpu"``.
"""

from __future__ import annotations

import os
import os.path as osp
import signal
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from shineon_tpu_torch.datasets.loader import DataLoader
from shineon_tpu_torch.serving import resolve_device
from shineon_tpu_torch.training.checkpointing import CheckpointKeeper
from shineon_tpu_torch.training.state import TrainState
from shineon_tpu_torch.utils import str2num
from shineon_tpu_torch.utils.log import get_logger

logger = get_logger()

TRACE_STEPS = (8, 12)  # the first and last step SHINEON_TRACE_DIR traces


class Trainer:
    def __init__(self, opt, device="cuda"):
        self.opt = opt
        self.device = resolve_device(device)
        self.experiment_dir = osp.join(opt.experiments_dir, opt.name)
        os.makedirs(self.experiment_dir, exist_ok=True)
        from torch.utils.tensorboard import SummaryWriter

        self.board = SummaryWriter(log_dir=osp.join(self.experiment_dir, "tb"))
        self.keeper: Optional[CheckpointKeeper] = None
        self.global_step = 0
        self._step_times: List[float] = []
        self._interrupted = False
        self._torn = False

    # ------------------------------------------------------------------ fit

    def fit(self, model, resume_state: Optional[TrainState] = None) -> TrainState:
        """Train ``model`` from ``model.init_state`` (a generator seeded with
        420, the reference's seed, train.py:29) or from ``resume_state``,
        made by the caller for this loader's steps an epoch and restored
        with ``load_checkpoint``. Returns the state."""
        opt = self.opt
        model.setup("fit")
        train_loader: DataLoader = model.train_dataloader()
        val_loader: DataLoader = model.val_dataloader()
        steps_per_epoch = max(len(train_loader), 1)
        if resume_state is None:
            state = model.init_state(torch.Generator().manual_seed(420), steps_per_epoch)
        else:
            state = resume_state
            self.global_step = int(state.step)
            # the schedules count epochs of this loader, as the JAX Trainer
            # rebuilds its model's optimizers (init_state) for it
            for net in state.nets.values():
                net.optimizer.schedule.steps_per_epoch = steps_per_epoch
        train_step = model.make_train_step()
        val_step = model.make_val_step()
        visual_fn = model.make_visual_step()

        self.keeper = CheckpointKeeper(osp.join(self.experiment_dir, "checkpoints"),
                                       save_count=opt.save_count)
        self.keeper.write_hparams(opt)
        self.board.add_text("hparams", _format_hparams(opt))

        vci = str2num(opt.val_check_interval)
        val_every = max(int(vci * steps_per_epoch) if isinstance(vci, float) else int(vci), 1)
        max_epochs = opt.keep_epochs + opt.decay_epochs
        if opt.fast_dev_run:
            max_epochs, val_every = 1, 1

        previous_handler = self._install_interrupt_handler()
        trace_dir = os.environ.get("SHINEON_TRACE_DIR")
        profiler = None
        try:
            for epoch in range(max_epochs):
                train_loader.set_epoch(epoch)
                for batch in train_loader:
                    device_batch = self.to_device(batch)
                    t0 = time.perf_counter()
                    if trace_dir and self.global_step == TRACE_STEPS[0]:
                        profiler = _start_trace()
                    metrics = self._run_step(train_step, state, device_batch)
                    if self.global_step % opt.display_count == 0:
                        self._log_scalars(metrics, prefix="")
                        model.visualize_from(visual_fn, state, device_batch, batch, self.board,
                                             self.global_step, tag="train")
                    self._step_times.append(time.perf_counter() - t0)
                    if profiler is not None and self.global_step == TRACE_STEPS[1]:
                        _stop_trace(profiler, trace_dir)
                        profiler = None
                    self.global_step += 1
                    if self.global_step % val_every == 0:
                        self._run_validation(model, val_step, visual_fn, state, val_loader)
                    self.keeper.maybe_save_step(self.global_step, state)
                    if self._interrupted:
                        self._save_interrupt(state, "Ctrl-C")
                        raise SystemExit(1)
                    if opt.fast_dev_run:
                        break
                if opt.fast_dev_run:
                    break
            self.keeper.save_final(state, self.global_step)
            self._report_profile()
        except KeyboardInterrupt:
            self._save_interrupt(state, "Ctrl-C")
            raise
        except Exception as exc:  # the reference's train.py:61-66
            logger.warning(f"Caught a {type(exc)}!")
            self._save_interrupt(state, exc.__class__.__name__)
            raise
        finally:
            if profiler is not None:
                _stop_trace(profiler, trace_dir)
            self.board.flush()
            if previous_handler is not None:
                signal.signal(signal.SIGINT, previous_handler)
        return state

    def _run_step(self, train_step, state: TrainState, device_batch) -> Dict:
        """One train step; on an exception, whether it changed the state."""
        versions = _versions(state)
        try:
            return train_step(state, device_batch)
        except BaseException:
            self._torn = _versions(state) != versions
            raise

    def _run_validation(self, model, val_step, visual_fn, state, val_loader):
        losses = defaultdict(list)
        # the loader already holds limit_val_batches
        nb = 1 if self.opt.fast_dev_run else len(val_loader)
        last = None
        for i, batch in enumerate(val_loader):
            if i >= nb:
                break
            device_batch = self.to_device(batch)
            for k, v in val_step(state, device_batch).items():
                losses[k].append(float(v))
            last = (device_batch, batch)
        means = {k: float(np.mean(v)) for k, v in losses.items()}
        self._log_scalars(means, prefix="val_")
        checkpoint_on = means.get("checkpoint_on", means.get("loss", 0.0))
        self.keeper.save_validation(self.global_step, state, checkpoint_on)
        if last is not None:  # the last val batch's images (base_model.py:155-163)
            model.visualize_from(visual_fn, state, last[0], last[1], self.board,
                                 self.global_step, tag="validation")

    # ----------------------------------------------------------------- test

    def test(self, model, state: TrainState) -> None:
        """The model's export over the test loader. The ragged last batch
        is padded on the device to ``batch_size`` by repeating its last
        sample; the host's names stay unpadded, so no export writes a pad."""
        model.setup("test")
        batch_size = self.opt.batch_size
        for batch in model.test_dataloader():
            model.test_step(state, self.to_device(_pad_ragged_batch(batch, batch_size)), batch)
        logger.info("test pass complete")

    # -------------------------------------------------------------- helpers

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch's numeric arrays on the trainer's device (from pinned
        memory, without waiting, on a card); names stay on the host."""
        out = {}
        for key, value in batch.items():
            if isinstance(value, np.ndarray):
                tensor = torch.from_numpy(value)
                if self.device.type == "cuda":
                    tensor = tensor.pin_memory().to(self.device, non_blocking=True)
                out[key] = tensor
        return out

    def _log_scalars(self, metrics: Dict, prefix: str = ""):
        for key, value in metrics.items():
            if key != "checkpoint_on":
                self.board.add_scalar(f"{prefix}{key}", float(value), self.global_step)

    def _install_interrupt_handler(self):
        """SIGINT sets a flag the loop reads at each step boundary; returns
        the handler it replaced (None off the main thread)."""

        def handler(signum, frame):
            self._interrupted = True

        try:
            return signal.signal(signal.SIGINT, handler)
        except ValueError:  # not the main thread
            return None

    def _save_interrupt(self, state: TrainState, name: str):
        if self.keeper is None:
            logger.warning("Nothing to checkpoint: training has not started.")
            return
        if self._torn:
            logger.error(f"Training stopped in the middle of step {self.global_step}, which had "
                         f"updated part of the state: no interrupted_by_{name} checkpoint is "
                         f"written; the last saved checkpoint stands.")
            return
        path = self.keeper.save_named(f"interrupted_by_{name}", state)
        logger.warning(f"Training stopped prematurely. Saved checkpoint to: {path}")

    def _report_profile(self):
        """The host's time in each step call, the first two dropped (the
        reference's profiler=True); on a card that is launch time."""
        if len(self._step_times) <= 2:
            return
        times = np.asarray(self._step_times[2:])
        logger.info("profiler | steps=%d mean=%.1fms p50=%.1fms p95=%.1fms" % (
            len(times), 1e3 * times.mean(), 1e3 * np.percentile(times, 50),
            1e3 * np.percentile(times, 95)))


def _versions(state: TrainState) -> List[int]:
    """The version counter of every tensor of the state: any in-place
    update moves one."""
    out = [int(state.step)]
    for net in state.nets.values():
        out += [t._version for t in net.module.state_dict(keep_vars=True).values()]
        out += net.optimizer.versions()
    return out


def _start_trace():
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_trace(profiler, trace_dir: str) -> None:
    profiler.stop()
    os.makedirs(trace_dir, exist_ok=True)
    profiler.export_chrome_trace(osp.join(trace_dir, "trace.json"))


def _pad_ragged_batch(batch: Dict, batch_size: int) -> Dict:
    """Pad the numpy leaves on axis 0 to ``batch_size`` by repeating the last
    sample; other leaves (name lists) as they are."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray) and value.ndim >= 1:
            short = batch_size - value.shape[0]
            if short > 0:
                value = np.concatenate([value, np.repeat(value[-1:], short, axis=0)], axis=0)
        out[key] = value
    return out


def _format_hparams(opt) -> str:
    return "\n".join(f"{k}: {v}" for k, v in sorted(vars(opt).items()))
