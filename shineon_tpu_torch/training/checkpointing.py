"""Checkpoints (counterpart of shineon_tpu/training/checkpointing.py; the
reference's writers, SURVEY §5.4), torch-native:

  * top-k (5) on the validation loss ``checkpoint_on``, the lowest kept
    (ModelCheckpoint save_top_k=5);
  * every ``save_count`` steps, the 3 latest kept (CheckpointEveryNSteps);
  * named saves: ``FINAL_step=N`` and ``interrupted_by_<Name>``
    (save_on_interrupt, train.py:121-141);
  * the option namespace in ``hparams.json``.

Layout: ``{experiments_dir}/{name}/checkpoints/{topk,steps}/<step>/`` and
``named/<name>/``, each holding ``state.pt``, plus ``hparams.json``. A
state file holds, for each network of the train state, the module's
``state_dict`` (parameters and every buffer: norm statistics, spectral
``u`` and ``sigma``) and its Adam's moments and count, and the step: only
tensors, numbers, strings, lists and dicts, so that it loads with
``torch.load(..., weights_only=True)``. Every save copies the state to the
host, then writes it, before it returns: nothing reads the live tensors
that the next step updates in place.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import shutil
from typing import Dict, Optional

import torch

from shineon_tpu_torch.training.state import TrainState
from shineon_tpu_torch.utils.log import get_logger

logger = get_logger()

STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
KEEP_STEPS = 3  # the every-N writer's saves kept, the latest first (orbax's max_to_keep)


def _to_jsonable(value):
    try:
        json.dumps(value)
        return value
    except TypeError:
        return str(value)


def state_to_host(state: TrainState) -> Dict:
    """The train state as host tensors, numbers and containers."""
    return {"step": int(state.step), "nets": {
        name: {"module": {k: v.detach().to("cpu", copy=True)
                          for k, v in net.module.state_dict().items()},
               "optimizer": net.optimizer.state_dict()}
        for name, net in state.nets.items()}}


def save_checkpoint(path: str, state: TrainState) -> str:
    """Write ``state`` into the directory ``path``, replacing what it held."""
    payload = state_to_host(state)
    if osp.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    torch.save(payload, osp.join(path, STATE_FILE))
    return path


def load_checkpoint(path: str, template_state: Optional[TrainState] = None,
                    map_location="cpu", modules_only: bool = False):
    """Read a checkpoint written by any writer here (its directory or its
    ``state.pt``), with ``weights_only=True``. With ``template_state`` (made
    by the model's ``init_state``) the modules, the optimizers and the step
    are restored into it in place and it is returned; without, the raw dict.
    The checkpoint must hold the template's networks and no other. With
    ``modules_only`` (a test run, which restores the generator of a training
    checkpoint) it may hold more, which are left out, and only the modules
    and the step are restored, not the optimizers."""
    if osp.isdir(path):
        path = osp.join(path, STATE_FILE)
    payload = torch.load(path, map_location=map_location, weights_only=True)
    if template_state is None:
        return payload
    saved = sorted(payload["nets"])
    if modules_only:
        saved = [name for name in saved if name in template_state.nets]
    if saved != sorted(template_state.nets):
        raise ValueError(f"the checkpoint holds {sorted(payload['nets'])}, the template "
                         f"{sorted(template_state.nets)}")
    for name, net in template_state.nets.items():
        net.module.load_state_dict(payload["nets"][name]["module"])
        if not modules_only:
            net.optimizer.load_state_dict(payload["nets"][name]["optimizer"])
    template_state.step = int(payload["step"])
    return template_state


def load_hparams(checkpoint_path: str) -> Optional[Dict]:
    """The ``hparams.json`` found walking up from a checkpoint path."""
    path = osp.abspath(checkpoint_path)
    for _ in range(5):
        candidate = osp.join(path, "hparams.json")
        if osp.exists(candidate):
            with open(candidate) as f:
                return json.load(f)
        path = osp.dirname(path)
    return None


class CheckpointKeeper:
    """The writers above over one ``checkpoints`` directory. A keeper made
    over a directory that holds saves takes them up, as orbax's managers do."""

    def __init__(self, root: str, save_count: int = 10000, top_k: int = 5):
        self.root = osp.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.save_count = save_count
        self.top_k = top_k
        self._topk = {step: self._read_metric(step) for step in self._saved("topk")}
        self._steps = self._saved("steps")

    def _saved(self, kind: str):
        folder = osp.join(self.root, kind)
        if not osp.isdir(folder):
            return []
        return sorted(int(d) for d in os.listdir(folder) if d.isdigit())

    def _read_metric(self, step: int) -> float:
        with open(osp.join(self.root, "topk", str(step), METRICS_FILE)) as f:
            return float(json.load(f)["checkpoint_on"])

    def write_hparams(self, opt) -> None:
        payload = {k: _to_jsonable(v) for k, v in sorted(vars(opt).items())}
        with open(osp.join(self.root, "hparams.json"), "w") as f:
            json.dump(payload, f, indent=2)

    def save_validation(self, step: int, state: TrainState, checkpoint_on: float) -> bool:
        """Top-k writer, keyed on the validation mean of ``checkpoint_on``:
        keeps the ``top_k`` lowest (an earlier save wins a tie). Returns
        whether ``state`` was kept."""
        step, value = int(step), float(checkpoint_on)
        ranked = sorted(self._topk.items(), key=lambda kv: (kv[1], kv[0]))
        if len(ranked) >= self.top_k and value >= ranked[self.top_k - 1][1]:
            return False
        path = save_checkpoint(osp.join(self.root, "topk", str(step)), state)
        with open(osp.join(path, METRICS_FILE), "w") as f:
            json.dump({"checkpoint_on": value}, f)
        self._topk[step] = value
        ranked = sorted(self._topk.items(), key=lambda kv: (kv[1], kv[0]))
        for old, _ in ranked[self.top_k:]:
            shutil.rmtree(osp.join(self.root, "topk", str(old)))
            del self._topk[old]
        return True

    def maybe_save_step(self, step: int, state: TrainState) -> bool:
        """Every ``save_count`` steps; the KEEP_STEPS latest are kept."""
        if step <= 0 or step % self.save_count:
            return False
        save_checkpoint(osp.join(self.root, "steps", str(int(step))), state)
        self._steps = sorted(set(self._steps) | {int(step)})
        for old in self._steps[:-KEEP_STEPS]:
            shutil.rmtree(osp.join(self.root, "steps", str(old)))
        self._steps = self._steps[-KEEP_STEPS:]
        logger.info(f"Saved N-step checkpoint at {step}")
        return True

    def save_named(self, name: str, state: TrainState) -> str:
        return save_checkpoint(osp.join(self.root, "named", name), state)

    def save_final(self, state: TrainState, step: int) -> str:
        return self.save_named(f"FINAL_step={int(step)}", state)
