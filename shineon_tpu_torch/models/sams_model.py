"""SAMS model: features, autoregressive clip generation and the 3-optimizer
GAN training step (counterpart of shineon_tpu/models/sams_model.py).

The step (:meth:`SamsModel.make_train_step`) is the JAX package's fused
step, run eagerly:

  1. generator update: synthesize the clip frame by frame (the
     previous-frame window detached at the generator's input, live in the
     flow-warp composite, as the reference's ``.detach()``), hinge
     adversarial terms of the multiscale and temporal discriminators, L1
     and VGG; the gradient covers the generator's parameters only;
  2. regenerate the clip with the updated generator, without gradient, in
     training mode (its statistics update a second time), or, with
     ``fast_gan_step``, reuse the step 1 clip;
  3. multiscale-discriminator update; 4. temporal-discriminator update,
     each on one concatenated fake+real pass, then split.

The validation step (:meth:`SamsModel.make_val_step`) runs the same
objective in eval mode without gradient; the visual step
(:meth:`SamsModel.make_visual_step`) returns the generated clip beside its
inputs.

Compute-dtype policy (shineon_tpu/models/base_model.py:88-94): ``precision
16`` runs the networks in bf16 while parameters stay f32; flows, sampling
grids, norm statistics and the losses stay f32.
"""

from __future__ import annotations

import argparse
import logging
import os.path as osp
from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from shineon_tpu_torch import tracing
from shineon_tpu_torch.datasets.channels import RGB_CHANNELS, channels_for
from shineon_tpu_torch.datasets.n_frames_interface import fold_frames_into_channels
from shineon_tpu_torch.datasets.preprocess import preprocess_batch
from shineon_tpu_torch.models.base_model import BaseModel, channels_of, gradients, to_numpy
from shineon_tpu_torch.networks.attention import INIT_STD as attention_init_std
from shineon_tpu_torch.networks.attention import SelfAttention
from shineon_tpu_torch.networks.discriminator import (
    MultiscaleDiscriminator,
    NLayerDiscriminator,
)
from shineon_tpu_torch.networks.init import (
    kernel_init_,
    lecun_normal_,
    normal_,
    store_spectral_init,
)
from shineon_tpu_torch.networks.layers import Conv2d
from shineon_tpu_torch.networks.loss import GANLoss, VGGLoss, l1_loss
from shineon_tpu_torch.networks.normalization import SpectralConv2d
from shineon_tpu_torch.networks.sams.sams_generator import SamsGenerator
from shineon_tpu_torch.networks.vgg import load_vgg19
from shineon_tpu_torch.ops import resample2d
from shineon_tpu_torch.training.state import NetState, TrainState
from shineon_tpu_torch.utils.visualization import get_save_paths, save_images


class SamsModel(BaseModel):
    """Owns the generator and, when ``opt.is_train``, the two
    discriminators and the losses; ``generate_n_frames`` is the clip loop,
    ``make_train_step`` the training step."""

    @classmethod
    def modify_commandline_options(cls, parser: argparse.ArgumentParser, is_train):
        """sams_model.py:63-101 of the JAX package, with the generator's,
        the discriminators' (training) and the GAN losses' options."""
        parser = argparse.ArgumentParser(parents=[parser], add_help=False)
        parser = super().modify_commandline_options(parser, is_train)
        parser.set_defaults(person_inputs=("agnostic", "densepose", "flow"))
        parser.add_argument(
            "--encoder_input", default="flow",
            help="which of the --person_inputs to use as the encoder segmap "
            "input (only 1 allowed).",
        )
        # a default for an option the dataset phase adds later: argparse
        # keeps the dataset's own default (1), as in the JAX package
        parser.set_defaults(n_frames_total=5)
        parser.set_defaults(batch_size=4)
        parser.add_argument("--wt_l1", type=float, default=1.0)
        parser.add_argument("--wt_vgg", type=float, default=1.0)
        parser.add_argument("--wt_multiscale", type=float, default=1.0)
        parser.add_argument("--wt_temporal", type=float, default=1.0)
        parser.add_argument(
            "--norm_D", type=str, default="spectralinstance",
            help="discriminator norm config string (e.g. spectralinstance)",
        )
        parser.add_argument(
            "--fast_gan_step", dest="fast_gan_step", action="store_true", default=False,
            help="Reuse the generator step's frames (detached) for the "
            "discriminator updates instead of regenerating with the "
            "updated generator: faster steps, a slight departure from the "
            "reference's per-optimizer regeneration.",
        )
        parser.add_argument(
            "--exact_gan_step", dest="fast_gan_step", action="store_false",
            help="[DEFAULT] Regenerate the clip with the updated generator "
            "before the discriminator updates (the reference's exact "
            "per-optimizer semantics).",
        )
        from shineon_tpu_torch import networks
        from shineon_tpu_torch.options import gan_options

        parser = networks.modify_commandline_options(parser, is_train)
        parser = gan_options.modify_commandline_options(parser, is_train)
        return parser

    @staticmethod
    def apply_default_encoder_input(opt):
        """An unset encoder map is the first person input."""
        if hasattr(opt, "encoder_input") and opt.encoder_input is None:
            opt.encoder_input = opt.person_inputs[0]
        return opt

    def __init__(self, opt, device="cuda"):
        super().__init__(opt, device)
        self.remat = bool(opt.remat)
        self.n_frames_now = getattr(opt, "n_frames_now", None) or self.n_frames_total
        self.inputs = list(opt.person_inputs) + list(opt.cloth_inputs)
        self.generator = SamsGenerator(
            norm_G=opt.norm_G, ngf_base=opt.ngf_base, ngf_pow_outer=opt.ngf_pow_outer,
            ngf_pow_inner=opt.ngf_pow_inner, ngf_pow_step=opt.ngf_pow_step,
            num_middle=opt.num_middle,
            attention_middle_indices=tuple(opt.attention_middle_indices),
            attention_decoder_indices=tuple(opt.attention_decoder_indices),
            activation=opt.activation or "relu", n_frames_total=self.n_frames_total,
            flow_warp=opt.flow_warp, encoder_input=opt.encoder_input,
            inputs=tuple(self.inputs), dtype=self.compute_dtype,
            # serving options: the test command line's (none in training)
            int8=getattr(opt, "int8_spade", False),
            int8_min_channels=getattr(opt, "int8_min_channels", 64),
        ).to(device)
        if opt.is_train:
            # intermediate features follow --no_ganFeat_loss, as in the reference
            d_kw = dict(ndf=opt.ndf, n_layers=opt.n_layers_D, norm_D=opt.norm_D,
                        get_intermediate_features=not opt.no_ganFeat_loss,
                        dtype=self.compute_dtype)
            self.multiscale_discriminator = MultiscaleDiscriminator(
                channels_of(self.inputs) + RGB_CHANNELS, num_D=opt.num_D, **d_kw).to(device)
            temporal_in = self.n_frames_total * (channels_for(opt.encoder_input) + RGB_CHANNELS)
            self.temporal_discriminator = NLayerDiscriminator(temporal_in, **d_kw).to(device)
            self.criterion_gan = GANLoss(opt.gan_mode)
            # with wt_vgg 0 the VGG term is never optimized: random filters are harmless
            vgg = load_vgg19(allow_random=opt.allow_random_vgg or opt.wt_vgg == 0,
                             dtype=self.compute_dtype)
            self.criterion_vgg = VGGLoss(vgg.to(device))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """The JAX package's rules: flax's defaults (lecun-normal kernels,
        zero biases, spectral ``u`` ~ N(0, 1)), except the attention blocks'
        1x1 convs, N(0, 0.02), and their gamma, 0; a spectral conv stores its
        kernel divided by one power step's sigma from that ``u``
        (:func:`store_spectral_init`). Drawn on the CPU, then copied to the
        device."""
        attention_convs = set()
        for m in self.generator.modules():  # a block comes before its convs
            if isinstance(m, SelfAttention):
                attention_convs.update(m.convs())
                m.gamma.zero_()
            if isinstance(m, (Conv2d, SpectralConv2d)):
                w = torch.empty(m.weight.shape)
                if m in attention_convs:
                    normal_(w, attention_init_std, generator)
                else:
                    lecun_normal_(w, generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            if isinstance(m, SpectralConv2d):
                store_spectral_init(m, generator)

    @torch.no_grad()
    def init_discriminator_weights(self, generator: torch.Generator):
        """The JAX package's rules, the multiscale discriminator first: each
        kernel drawn by ``init_type`` with gain ``init_variance``
        (``kernel_init_``), zero biases, and under a spectral ``norm_D`` (the
        default ``spectralinstance``) ``u`` ~ N(0, 1) and the kernel stored
        divided by one power step's sigma from it (:func:`store_spectral_init`).
        So a spectral kernel's scale is set by the power step, not by the
        gain: normal, xavier and kaiming store the same kernel from one
        draw, with a largest singular value a little above 1, and
        orthogonal's is 1."""
        for d in (self.multiscale_discriminator, self.temporal_discriminator):
            for m in d.modules():
                if isinstance(m, (Conv2d, SpectralConv2d)):
                    kernel_init_(m.weight, self.opt.init_type, self.opt.init_variance, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                if isinstance(m, SpectralConv2d):
                    store_spectral_init(m, generator)

    def init_state(self, generator: torch.Generator, steps_per_epoch: int) -> TrainState:
        """Draw every network's weights from ``generator`` (the generator's
        first; the discriminators only for training), then
        :meth:`make_state`."""
        self.init_weights(generator)
        if self.opt.is_train:
            self.init_discriminator_weights(generator)
        return self.make_state(steps_per_epoch)

    def make_state(self, steps_per_epoch: int) -> TrainState:
        """Step 0 and fresh optimizers over the networks' current weights:
        Adam at ``lr`` for the generator, ``lr_D`` for each discriminator
        (training only), on the keep/decay schedule."""
        opt = self.opt
        nets = {"generator": self.net_state(self.generator, getattr(opt, "lr", 1e-4),
                                            steps_per_epoch)}
        if opt.is_train:
            nets["d_multi"] = self.net_state(self.multiscale_discriminator, opt.lr_D,
                                             steps_per_epoch)
            nets["d_temporal"] = self.net_state(self.temporal_discriminator, opt.lr_D,
                                                steps_per_epoch)
        return TrainState(nets=nets)

    def features(self, raw_batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """SAMS keeps the frames axis: (B, N, H, W, C) features."""
        return preprocess_batch(raw_batch, self.preprocess_config)

    def frame(self, window, prev_maps, current_maps, train: bool):
        """One frame's generator call, the clip loop's body (its inputs
        from :meth:`loop_inputs`); in training it updates the running
        statistics and spectral ``u``. With ``remat`` and gradients on, the
        frame's activations are recomputed in the backward pass
        (``jax.checkpoint`` in the JAX package) by :func:`checkpointed`."""
        g = self.generator
        if train and self.remat and torch.is_grad_enabled():
            return checkpointed(g, window, prev_maps, current_maps, train=True,
                                update_stats=True)
        return g(window, prev_maps, current_maps, train=train, update_stats=train)

    def loop_inputs(self, feats: Dict[str, torch.Tensor], train: bool):
        """What the clip loop's generator calls read: (the empty
        previous-frame window, ``frame_maps``), where ``frame_maps(t)`` is
        frame t's (prev_maps, current_maps): the encoder maps of the frames
        before t (zeros where there are none) and frame t's label maps. In
        eval mode the window and the maps are in the compute dtype."""
        opt = self.opt
        N = self.n_frames_total
        labelmap = {key: feats[key] for key in self.inputs}
        enc_maps = feats[opt.encoder_input]  # (B, N, H, W, enc_ch)
        image = feats["image"]
        if not train and self.compute_dtype is not None:
            labelmap = {k: v.to(self.compute_dtype) for k, v in labelmap.items()}
            enc_maps = enc_maps.to(self.compute_dtype)
        win_dtype = image.dtype if train else (self.compute_dtype or image.dtype)
        # the previous-frame window [oldest .. newest], zeros until generated
        window = torch.zeros(image.shape[:1] + (N - 1,) + image.shape[2:],
                             dtype=win_dtype, device=image.device)

        def frame_maps(t: int):
            k = (N - 1) - t
            prev_maps = torch.cat(
                [torch.zeros_like(enc_maps[:, :k]), enc_maps[:, k:N - 1]], dim=1
            )
            return prev_maps, {key: v[:, t] for key, v in labelmap.items()}

        return window, frame_maps

    def generate_n_frames(self, feats: Dict[str, torch.Tensor], train: bool):
        """Autoregressive clip synthesis (sams_model.py:244-396 of the JAX
        package; its ``lax.scan`` is a Python loop here).

        In training mode (the training step, the serving warm-up) the
        generator runs with batch statistics and updates its running
        statistics and spectral ``u`` in place. The generator sees the
        previous-frame window detached, as the JAX package's
        ``stop_gradient`` (:336) and the reference's ``.detach()``; the
        flow-warp composite reads the live window, so with gradients on the
        clip's frames depend on the earlier frames through the warp only.
        Returns (fake_frame, current_maps, all_frames (B, N, H, W, 3)): what
        the training losses read.
        """
        opt = self.opt
        N = self.n_frames_total
        start_idx = N - self.n_frames_now
        flows = feats.get("flow") if opt.flow_warp else None  # stays f32
        window, frame_maps = self.loop_inputs(feats, train)

        if N == 1:
            with tracing.span("sams.frame"):
                _, current_maps = frame_maps(0)
                out = self.frame(None, None, current_maps, train)
                fake = out[..., :RGB_CHANNELS]
                if opt.flow_warp:
                    wmask = out[..., RGB_CHANNELS:]
                    warped = resample2d(torch.zeros_like(fake), flows[:, 0])
                    fake = (1 - wmask) * warped + wmask * fake
            return fake, current_maps, fake[:, None]

        fakes = []
        for t in range(start_idx, N):
            with tracing.span("sams.frame"):
                prev_maps, current_maps = frame_maps(t)
                out = self.frame(window.detach(), prev_maps, current_maps, train)
                fake = out[..., :RGB_CHANNELS]
                if opt.flow_warp:
                    wmask = out[..., RGB_CHANNELS:]
                    # the reference warps buffer[t-1], the window's newest slot
                    warped = resample2d(window[:, -1], flows[:, t])
                    fake = (1 - wmask) * warped + wmask * fake
                window = torch.cat([window[:, 1:], fake[:, None].to(window.dtype)], dim=1)
                fakes.append(fake)
        gen_frames = torch.stack(fakes, dim=1)
        if start_idx:
            gen_frames = torch.cat(
                [gen_frames.new_zeros(gen_frames[:, :1].shape).repeat(1, start_idx, 1, 1, 1),
                 gen_frames], dim=1,
            )
        return fakes[-1], current_maps, gen_frames  # current_maps: the last frame's

    # ------------------------------------------------------------ training

    def mask_unused_frames(self, tensor: torch.Tensor) -> torch.Tensor:
        """Zero the first (total - now) frames (sams_model.py:663-678)."""
        n_mask = self.n_frames_total - self.n_frames_now
        if n_mask == 0:
            return tensor
        mask = torch.ones_like(tensor)
        mask[:, :n_mask] = 0
        return tensor * mask

    @staticmethod
    def discriminate(disc, sem, fake, real, update_stats: bool = False):
        """One concatenated fake+real pass, then split (sams_model.py:702-720).
        ``update_stats`` stores the discriminator's spectral state."""
        both = torch.cat([torch.cat([sem, fake], dim=-1), torch.cat([sem, real], dim=-1)], dim=0)
        return split_predictions(disc(both, update_stats=update_stats))

    def _temporal_inputs(self, feats, all_frames):
        """The temporal discriminator's frame-folded (sem, fake, real)."""
        sem = fold_frames_into_channels(self.mask_unused_frames(feats[self.opt.encoder_input]))
        real = fold_frames_into_channels(self.mask_unused_frames(feats["image"]))
        return sem, fold_frames_into_channels(all_frames), real  # fakes pre-masked

    def generator_losses(self, feats: Dict[str, torch.Tensor], train: bool = True):
        """The generator's objective (the JAX package's ``_generator_losses``):
        the clip, the adversarial terms of both discriminators (which store
        no statistics here), L1 and VGG on the last frame. With
        ``reference_gan_semantics`` the adversarial terms read the real
        predictions, as the reference does (sams_model.py:616-620). Returns
        (loss_G, metrics, fake_frame, all_frames, current_maps)."""
        opt = self.opt
        fake_frame, current_maps, all_frames = self.generate_n_frames(feats, train)
        ground_truth = feats["image"][:, -1]
        sem = torch.cat([current_maps[k] for k in self.inputs], dim=-1)
        which = 1 if opt.reference_gan_semantics else 0  # (fake, real)[which]
        preds = self.discriminate(self.multiscale_discriminator, sem, fake_frame, ground_truth)
        loss_adv_multi = self.criterion_gan(preds[which], True, for_discriminator=False)
        loss_adv_multi = loss_adv_multi * opt.wt_multiscale
        preds_t = self.discriminate(self.temporal_discriminator,
                                    *self._temporal_inputs(feats, all_frames))
        loss_adv_temp = self.criterion_gan(preds_t[which], True, for_discriminator=False)
        loss_adv_temp = loss_adv_temp * opt.wt_temporal
        loss_l1 = l1_loss(fake_frame, ground_truth) * opt.wt_l1
        loss_vgg = self.criterion_vgg(fake_frame, ground_truth) * opt.wt_vgg
        loss_G = loss_l1 + loss_vgg + loss_adv_multi + loss_adv_temp
        metrics = {
            "loss": loss_G,
            "loss/G/adv_multiscale": loss_adv_multi,
            "loss/G/adv_temporal": loss_adv_temp,
            "loss/G/l1+vgg": loss_l1 + loss_vgg,
            "loss/G/l1": loss_l1,
            "loss/G/vgg": loss_vgg,
        }
        return loss_G, metrics, fake_frame, all_frames, current_maps

    def _update_discriminator(self, net: NetState, sem, fake, real):
        """One discriminator's hinge update on the fake+real pass, which
        stores its spectral state. Returns (loss, loss_real, loss_fake)."""
        pred_fake, pred_real = self.discriminate(net.module, sem, fake, real, update_stats=True)
        loss_fake = self.criterion_gan(pred_fake, False, True)
        loss_real = self.criterion_gan(pred_real, True, True)
        loss = (loss_fake + loss_real) / 2
        net.optimizer.step(gradients(loss, net.optimizer.params))
        return loss, loss_real, loss_fake

    def make_train_step(self):
        """The training step ``step(state, raw_batch) -> metrics`` (module
        docstring); it updates ``state`` in place. The metrics carry the JAX
        package's names, the losses as 0-d tensors on the device."""
        fast = self.opt.fast_gan_step
        if fast:
            logging.getLogger(__name__).warning(
                "fast_gan_step: the discriminator updates reuse the pre-update "
                "generator's frames (an approximation of the reference's "
                "per-optimizer regeneration)")

        def train_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            feats = self.features(raw_batch)
            g_net = state.nets["generator"]
            lr = g_net.optimizer.schedule(state.step)

            # 1. generator update; the gradient covers G's parameters only
            loss_G, metrics, fake_frame, all_frames, current_maps = self.generator_losses(feats)
            g_net.optimizer.step(gradients(loss_G, g_net.optimizer.params))
            if fast:
                fake_frame, all_frames = fake_frame.detach(), all_frames.detach()
            else:
                # 2. regenerate with the updated generator, its statistics
                # updated a second time
                with torch.no_grad():
                    fake_frame, current_maps, all_frames = self.generate_n_frames(
                        feats, train=True)

            # 3. multiscale D, 4. temporal D
            ground_truth = feats["image"][:, -1]
            sem = torch.cat([current_maps[k] for k in self.inputs], dim=-1)
            dm = self._update_discriminator(state.nets["d_multi"], sem, fake_frame, ground_truth)
            dt = self._update_discriminator(state.nets["d_temporal"],
                                            *self._temporal_inputs(feats, all_frames))
            metrics = {k: v.detach() for k, v in metrics.items()}
            for name, (loss, real, fake) in (("multi", dm), ("temporal", dt)):
                metrics[f"loss/D/{name}"] = loss.detach()
                metrics[f"loss/D/{name}_fake"] = fake.detach()
                metrics[f"loss/D/{name}_real"] = real.detach()
            metrics["lr"] = lr
            state.step += 1
            return metrics

        return train_step

    def make_val_step(self):
        """``step(state, raw_batch) -> metrics``: the generator's objective
        in eval mode (running statistics, no update of any state), without
        gradient, and ``checkpoint_on``: L1 + VGG of the last frame with their
        weights (sams_model.py:610-626 of the JAX package). On the card its
        SPADE chains run the fused chain kernel."""

        @torch.no_grad()
        def val_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            feats = self.features(raw_batch)
            _, metrics, fake_frame, _, _ = self.generator_losses(feats, train=False)
            ground_truth = feats["image"][:, -1]
            metrics["checkpoint_on"] = (
                l1_loss(fake_frame, ground_truth) * self.opt.wt_l1
                + self.criterion_vgg(fake_frame, ground_truth) * self.opt.wt_vgg)
            return metrics

        return val_step

    def make_visual_step(self):
        """``step(state, raw_batch) -> tensors``: the eval-mode clip
        ``all_gen_frames`` (B, N, H, W, 3) beside the frames, the cloth and
        the person inputs that are displayed (sams_model.py:628-643)."""

        @torch.no_grad()
        def visual_step(state: TrainState, raw_batch: Dict[str, torch.Tensor]):
            feats = self.features(raw_batch)
            _, _, all_frames = self.generate_n_frames(feats, train=False)
            out = {"all_gen_frames": all_frames, "image": feats["image"],
                   "cloth": feats["cloth"]}
            for name in ("silhouette", "im_head", "im_cocopose", "densepose", "flow_image"):
                if name in feats:
                    out[name] = feats[name]
            return out

        return visual_step

    def visual_rows(self, v):
        """One row a displayed input and for the cloth, the generated clip
        and the frames, each frame a column (sams_model.py:722-742 of the
        reference)."""
        rows = []
        for name in self.replace_actual_with_visual():
            if name in v and v[name].ndim == 5:
                rows.append([v[name][:, i] for i in range(v[name].shape[1])])
        for key in ("cloth", "all_gen_frames", "image"):
            rows.append([v[key][:, i] for i in range(v[key].shape[1])])
        return rows

    @torch.no_grad()
    def test_step(self, state: TrainState, device_batch, host_batch) -> None:
        """Write each clip's final generated frame under ``tryon/`` or
        ``reconstruction/`` (sams_model.py:659-693 of the JAX package; the
        reference's own SAMS test step writes nothing), skipping a batch
        whose files all exist and each file that exists. On the card the
        generator's SPADE chains run the fused chain kernel."""
        dirs, names = self.export_targets(host_batch, "image_name", self.export_task())
        if all(osp.exists(p) for p in get_save_paths(dirs, names)):
            return
        fake_frame, _, _ = self.generate_n_frames(self.features(device_batch), train=False)
        save_images(to_numpy(fake_frame), names, dirs)


def checkpointed(module: torch.nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` whose activations are recomputed in the
    backward pass (``torch.utils.checkpoint``, non-reentrant).

    The forward updates the module's buffers in place (running statistics,
    spectral ``u``/``sigma``). A plain recompute would update them a second
    time and, worse, normalise the kernels with the already-updated ``u``:
    other activations, wrong gradients, no error. So the buffers are
    snapshotted before the call, and the recompute runs on copies of that
    snapshot (``torch.func.functional_call``): it sees what the forward saw
    and writes nothing the module keeps."""
    before = {name: b.clone() for name, b in module.named_buffers()}
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return module(*a, **kwargs)
        scratch = {name: b.clone() for name, b in before.items()}
        return torch.func.functional_call(module, scratch, a, kwargs)

    return checkpoint(run, *args, use_reentrant=False)


def split_predictions(pred):
    """Split the concatenated fake/real predictions (sams_model.py:696-708
    of the JAX package): (fake, real), each of the prediction's structure."""
    if isinstance(pred, (list, tuple)):
        fake, real = [], []
        for p in pred:
            if isinstance(p, (list, tuple)):
                fake.append([t[: t.shape[0] // 2] for t in p])
                real.append([t[t.shape[0] // 2:] for t in p])
            else:
                fake.append(p[: p.shape[0] // 2])
                real.append(p[p.shape[0] // 2:])
        return fake, real
    return pred[: pred.shape[0] // 2], pred[pred.shape[0] // 2:]
