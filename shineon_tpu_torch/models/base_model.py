"""What the port's models share (counterpart of
shineon_tpu/models/base_model.py): the compute dtype, the person and cloth
channel counts, the device features, and the optimizer and schedule set-up.

A model is built for one device (``cuda`` unless the caller says ``cpu``)
and its training state is updated in place by its steps:

* ``init_state(generator, steps_per_epoch) -> TrainState``
* ``make_train_step() -> step(state, raw_batch) -> metrics``
* ``make_val_step() -> step(state, raw_batch) -> metrics`` (eval-mode norms,
  no gradient; ``checkpoint_on`` is the value a checkpoint is chosen by)
* ``make_visual_step() -> step(state, raw_batch) -> tensors to display``
* ``test_step(state, device_batch, host_batch)`` writes the model's export
  PNGs (skipping files that exist)

and owns the runtime hooks the trainer calls (shineon_tpu/models/
base_model.py:98-240): ``setup(stage)`` builds the datasets, the train,
val and test loaders batch them, ``visualize_from`` writes the board's
image rows (``visual_rows``), and ``override_hparams`` takes new options
after a checkpoint is loaded (with ``is_train`` off, the export goes under
``test_results_dir``).
"""

from __future__ import annotations

import argparse
import os.path as osp
from typing import Dict, List, Optional

import numpy as np
import torch

from shineon_tpu_torch.datasets import find_dataset_using_name
from shineon_tpu_torch.datasets.channels import channels_for
from shineon_tpu_torch.datasets.loader import DataLoader
from shineon_tpu_torch.datasets.n_frames_interface import fold_frames_into_channels
from shineon_tpu_torch.datasets.preprocess import PreprocessConfig, preprocess_batch
from shineon_tpu_torch.training.optimizers import make_optimizer
from shineon_tpu_torch.training.state import NetState
from shineon_tpu_torch.utils import str2num
from shineon_tpu_torch.utils.log import get_logger
from shineon_tpu_torch.utils.visualization import board_add_images

logger = get_logger()


def compute_dtype_of(opt) -> Optional[torch.dtype]:
    """``precision 16`` runs the networks in bf16 while parameters stay f32;
    flows, sampling grids, norm statistics and the losses stay f32."""
    return torch.bfloat16 if getattr(opt, "precision", 32) == 16 else None


def channels_of(names) -> int:
    return sum(channels_for(n) for n in names)


def get_and_cat_inputs(feats: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """The named features concatenated on the channel (last) axis."""
    return torch.cat([feats[name] for name in names], dim=-1)


class BaseModel:
    @classmethod
    def modify_commandline_options(cls, parser: argparse.ArgumentParser, is_train):
        """The options every model takes (base_model.py:41-78 of the JAX
        package); a model's own setter extends them."""
        parser.add_argument(
            "--person_inputs", nargs="+",
            help="person-derived inputs to feed the network; each adds its channel "
            "count (see TryonDataset).",
        )
        parser.add_argument(
            "--cloth_inputs", nargs="+", default=("cloth",),
            help="cloth-derived inputs to feed the network.",
        )
        parser.add_argument("--ngf", type=int, default=64)
        parser.add_argument("--self_attn", action="store_true", help="insert self-attention blocks")
        parser.add_argument(
            "--no_self_attn", action="store_false", dest="self_attn",
            help="disable self-attention blocks",
        )
        parser.add_argument(
            "--num_attn", type=int, default=2,
            help="how many U-Net levels get self-attention, counted from the bottleneck",
        )
        parser.add_argument(
            "--flow_warp", action="store_true",
            help="flow-warp the previous generated frame into the composite",
        )
        parser.add_argument(
            "--allow_random_vgg", action="store_true",
            help="Permit the VGG perceptual loss to fall back to fixed random "
            "filters when no pretrained VGG19 weights are available "
            "(SHINEON_VGG19_WEIGHTS). Without this, missing weights abort "
            "training, since the objective would silently differ from the "
            "reference's ImageNet-VGG loss.",
        )
        parser.add_argument(
            "--remat", action="store_true",
            help="Recompute the generator's activations in the backward pass "
            "(torch.utils.checkpoint): trades recompute for device memory.",
        )
        return parser

    def __init__(self, opt, device="cuda"):
        self.opt = opt
        self.device = torch.device(device)
        self.n_frames_total = getattr(opt, "n_frames_total", 1)
        self.person_channels = channels_of(opt.person_inputs)
        self.cloth_channels = channels_of(opt.cloth_inputs)
        self.compute_dtype = compute_dtype_of(opt)
        self.preprocess_config = PreprocessConfig.from_opt(opt)

    def features(self, raw_batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The device features, frames folded into channels (frame-major)
        for the frame-stacked conv models."""
        feats = preprocess_batch(raw_batch, self.preprocess_config)
        return {k: fold_frames_into_channels(v) if v.dim() == 5 else v
                for k, v in feats.items()}

    def net_state(self, module: torch.nn.Module, lr: float, steps_per_epoch: int) -> NetState:
        """``module`` with optax's Adam at ``lr`` on the keep/decay schedule,
        accumulating ``accumulated_batches`` mini-steps an update. The test
        options have no training keys: their defaults, as in the JAX
        package."""
        opt = self.opt
        return NetState(module, make_optimizer(
            module.parameters(), lr, getattr(opt, "keep_epochs", 5),
            getattr(opt, "decay_epochs", 5), steps_per_epoch,
            getattr(opt, "accumulated_batches", 1)))

    # ------------------------------------------------------------ options

    def override_hparams(self, opt) -> None:
        """Take ``opt`` in place of the options the model was built with
        (base_model.py:76-89 of the reference); a test run exports under
        ``{result_dir}/{name}/{checkpoint name or "scratch"}/{datamode}``."""
        self.opt = opt
        if not opt.is_train:
            ckpt_name = osp.basename(osp.normpath(opt.checkpoint)) if opt.checkpoint else "scratch"
            self.test_results_dir = osp.join(opt.result_dir, opt.name, ckpt_name, opt.datamode)

    # ------------------------------------------------------------ datasets

    def setup(self, stage: str) -> None:
        """The main dataset, and for ``stage`` "fit" the validation one."""
        dataset_cls = find_dataset_using_name(self.opt.dataset)
        self.train_dataset = dataset_cls(self.opt)
        logger.info(f"main {self.opt.dataset} dataset ready ({len(self.train_dataset)} samples)")
        if stage == "fit":
            self.val_dataset = self.train_dataset.make_validation_dataset(self.opt)
            logger.info(f"validation {self.opt.dataset} dataset ready "
                        f"({len(self.val_dataset)} samples)")

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.train_dataset, batch_size=self.opt.batch_size,
                          shuffle=not self.opt.no_shuffle, workers=self.opt.workers,
                          limit_batches=str2num(self.opt.limit_train_batches))

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.val_dataset, batch_size=self.opt.batch_size,
                          shuffle=not self.opt.no_shuffle, workers=self.opt.workers,
                          limit_batches=str2num(self.opt.limit_val_batches))

    def test_dataloader(self) -> DataLoader:
        """In order, the ragged last batch kept."""
        return DataLoader(self.train_dataset, batch_size=self.opt.batch_size, shuffle=False,
                          workers=self.opt.workers, drop_last=False)

    # ------------------------------------------------------------ visuals

    def visualize_from(self, visual_fn, state, device_batch, host_batch, board, step,
                       tag="train") -> None:
        """The visual step's tensors, as the model's rows of board images."""
        visuals = visual_fn(state, device_batch)
        board_add_images(board, tag, self.visual_rows({k: to_numpy(v) for k, v in
                                                       visuals.items()}), step)

    def visual_rows(self, visuals: Dict[str, np.ndarray]) -> List[List[np.ndarray]]:
        """Rows of (B, H, W, C) images for the board grid."""
        raise NotImplementedError

    def fetch_person_visuals(self, feats: Dict) -> List:
        """The person inputs that can be shown as images (base_model.py:186-212
        of the reference): those of at most 3 channels after
        :meth:`replace_actual_with_visual`, the last frame's of a stacked clip."""
        out = []
        for name in self.replace_actual_with_visual():
            if name not in feats:
                continue
            tensor = feats[name]
            channels = tensor.shape[-1]
            if self.n_frames_total > 1 and tensor.ndim == 4:
                channels = tensor.shape[-1] // self.n_frames_total
                tensor = tensor[..., -channels:]
            if channels <= 3:
                out.append(tensor)
            else:
                logger.warning(f"Tried to visualize a tensor > 3 channels: '{name}' has "
                               f"{channels=}. Skipping it.")
        if not out:
            raise ValueError("no <=3-channel person inputs available to visualize")
        return out

    def replace_actual_with_visual(self) -> List[str]:
        """agnostic -> silhouette, im_head; cocopose -> im_cocopose; flow ->
        flow_image with ``visualize_flow`` (base_model.py:214-237)."""
        person_visuals = list(self.opt.person_inputs)
        if "agnostic" in person_visuals:
            i = person_visuals.index("agnostic")
            person_visuals.pop(i)
            person_visuals.insert(i, "im_head")
            person_visuals.insert(i, "silhouette")
        if "cocopose" in person_visuals:
            i = person_visuals.index("cocopose")
            person_visuals.pop(i)
            person_visuals.insert(i, "im_cocopose")
        if "flow" in person_visuals:
            i = person_visuals.index("flow")
            person_visuals.pop(i)
            if getattr(self.opt, "visualize_flow", False):
                person_visuals.insert(i, "flow_image")
        return person_visuals

    # ------------------------------------------------------------ export

    def test_step(self, state, device_batch, host_batch) -> None:
        raise NotImplementedError

    def export_targets(self, host_batch, name_key: str, folder: str):
        """(directories, names) of a batch's export: each sample's
        ``{test_results_dir}/{dataset name}/{folder}`` and its
        ``host_batch[name_key]``, a clip's last frame's."""
        names = last_frame_names(host_batch[name_key])
        datasets = host_batch["dataset_name"]
        if isinstance(datasets, str):
            datasets = [datasets] * len(names)
        dirs = [osp.join(self.test_results_dir, d, folder) for d in last_frame_names(datasets)]
        return dirs, names

    def export_task(self) -> str:
        """The export folder of TOM and SAMS: "tryon" for the try-on task
        (``tryon_list`` or ``random_tryon``), else "reconstruction"."""
        return "tryon" if self.opt.tryon_list or self.opt.random_tryon else "reconstruction"


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A device tensor as a float32 host array."""
    return tensor.detach().float().cpu().numpy()


def last_frame_names(names: List) -> List:
    """Per-sample names of a batch; a clip's (a list a sample) is its last
    frame's."""
    return [n[-1] if isinstance(n, list) else n for n in names]


def gradients(loss: torch.Tensor, params):
    """d loss / d params, zeros for a parameter the loss does not reach;
    no ``.grad`` is written."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
