"""The port's checkpoint loaders against the JAX package on the CPU.

* Reference Lightning checkpoints
  (shineon_tpu_torch.tools.convert_lightning_checkpoint): synthetic torch
  modules with the reference's layer plans (no published weights; the
  oracles of tests/test_checkpoint_conversion.py and
  tests/test_sams_conversion.py) for the GMM, TOM's U-Net and the SAMS
  generator, with a generator whose widths need ``encode_extra`` and
  ``decode_extra``. The port's converted ``state_dict`` equals
  shineon_tpu_torch.convert of the JAX converter's flax tree, the port's
  forward matches the JAX forward of that tree and the torch oracle's,
  and the command line writes a checkpoint the test entry exports from.
* JAX train states (convert.load_jax_train_state and
  tools.convert_jax_state): the JAX Trainer fits the tiny GMM and saves
  with orbax; the checkpoint is restored and dumped to ``.npz`` as the
  README says, converted, and one more port step matches one more JAX step
  (losses, parameters, both Adam moments, the accumulator); the tiny SAMS
  state's three networks, spectral statistics and moments map one to one.
* The VGG19 ``.npz`` against tools/convert_vgg19.py's on one random
  ``state_dict`` with torchvision's key layout.
"""

import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
from flax import serialization, traverse_util

import shineon_tpu.native as jnative
from fixtures import make_viton_fixture
from shineon_tpu_torch import convert
from shineon_tpu_torch.networks.cpvton.unet import UnetGenerator
from shineon_tpu_torch.networks.cpvton.warp import GMM
from shineon_tpu_torch.networks.sams.sams_generator import SamsGenerator
from shineon_tpu_torch.tools import convert_lightning_checkpoint as port_conv
from test_checkpoint_conversion import _torch_unet, _TorchGMM
from test_sams_conversion import TAttentiveMultiSpade, TMultiSpade, TResBlock, TSpade
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)
from tools import convert_lightning_checkpoint as jax_conv

LABELS = {"agnostic": 4, "cloth": 3, "densepose": 3, "flow": 2}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _assert_same_state_dicts(out, ref):
    assert sorted(out) == sorted(ref)
    for k, v in ref.items():
        assert torch.equal(out[k], v), k


def _randomize_stats(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) + 0.5)


# ------------------------------------------------------- Lightning: GMM, U-Net

def test_gmm_conversion_matches_jax_and_reference(rng):
    torch.manual_seed(420)
    H, W, gs = 128, 96, 3
    tmodel = _TorchGMM(4, 3, H, W, gs).eval()
    _randomize_stats(tmodel, 1)
    person = rng.randn(2, 4, H, W).astype(np.float32)
    cloth = rng.randn(2, 3, H, W).astype(np.float32)
    with torch.no_grad():
        theta_ref = tmodel(_t(person), _t(cloth)).numpy()
    sd = tmodel.state_dict()
    net, converted = port_conv.to_state_dict("warp", sd)
    assert net == "gmm"
    variables = jax_conv.convert_warp_state_dict(sd)
    _assert_same_state_dicts(converted, convert.flax_to_state_dict(variables,
                                                                   convert.GMM_RENAMES))
    gmm = GMM(4, 3, H, W, grid_size=gs).eval()
    gmm.load_state_dict(converted, strict=True)
    with torch.no_grad():
        grid, theta = gmm(_t(person.transpose(0, 2, 3, 1)), _t(cloth.transpose(0, 2, 3, 1)))

    from shineon_tpu.networks.cpvton import GMM as JGMM

    jgrid, jtheta = JGMM(fine_height=H, fine_width=W, grid_size=gs).apply(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(person.transpose(0, 2, 3, 1)),
        jnp.asarray(cloth.transpose(0, 2, 3, 1)), train=False)
    np.testing.assert_allclose(theta.numpy(), np.asarray(jtheta), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(theta.numpy(), theta_ref, rtol=1e-3, atol=2e-4)


def test_unet_conversion_matches_jax_and_reference(rng):
    torch.manual_seed(7)
    tmodel = _torch_unet(input_nc=7, output_nc=4, num_downs=6, num_attention=2, ngf=8).eval()
    with torch.no_grad():  # nonzero residual weights, so attention is exercised
        for name, p in tmodel.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.5)
    x = rng.randn(2, 7, 64, 64).astype(np.float32)
    with torch.no_grad():
        ref = tmodel(_t(x)).numpy().transpose(0, 2, 3, 1)
    sd = {f"unet.{k}": v for k, v in tmodel.state_dict().items()}
    net, converted = port_conv.to_state_dict("unet_mask", sd)
    assert net == "unet"
    variables = jax_conv.convert_unet_state_dict(sd)
    _assert_same_state_dicts(converted, convert.flax_to_state_dict(variables,
                                                                   convert.UNET_RENAMES))
    unet = UnetGenerator(7, 4, num_downs=6, num_attention=2, ngf=8, use_self_attn=True).eval()
    unet.load_state_dict(converted, strict=True)
    with torch.no_grad():
        out = unet(_t(x.transpose(0, 2, 3, 1))).numpy()

    from shineon_tpu.networks.cpvton import UnetGenerator as JUnet

    jout = JUnet(input_nc=7, output_nc=4, num_downs=6, num_attention=2, ngf=8, norm="instance",
                 use_self_attn=True).apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                           jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-4)


# ------------------------------------------------------ Lightning: SAMS

class TSamsGenAny(tnn.Module):
    """The reference SamsGenerator's layer lists (sams_generator.py:106-291)
    at any widths: encode_layers = [Conv2d] + [resblock, Upsample]* (the
    last resblock closing to ngf_base ** ngf_pow_inner when the steps miss
    it), middle_layers, decode_layers = [Upsample, resblock]* + [Conv2d]."""

    def __init__(self, pows, num_middle, attention_middle, n_frames):
        super().__init__()
        base, outer, inner, step = pows
        enc_nc = 2 * (n_frames - 1)
        widths = [base ** p for p in range(outer, inner, step)]
        enc_pairs = [(w, w * base ** step) for w in widths]
        if enc_pairs[-1][1] != base ** inner:
            enc_pairs.append((enc_pairs[-1][1], base ** inner))
        enc = [tnn.Conv2d(3 * (n_frames - 1), base ** outer, 3, padding=1)]
        for fin, fout in enc_pairs:
            enc += [TResBlock(fin, fout, lambda nc: TSpade(nc, enc_nc)),
                    tnn.Upsample(scale_factor=0.5)]
        self.encode_layers = tnn.ModuleList(enc)
        inner_w = base ** inner
        self.middle_layers = tnn.ModuleList([TResBlock(inner_w, inner_w, lambda nc: (
            TAttentiveMultiSpade if i in attention_middle else TMultiSpade)(nc, LABELS))
            for i in range(num_middle)])
        dec_pairs = [(base ** p, base ** (p - step)) for p in range(inner, outer, -step)]
        if dec_pairs[-1][1] != base ** outer:
            dec_pairs.append((dec_pairs[-1][1], base ** outer))
        dec = []
        for fin, fout in dec_pairs:
            dec += [tnn.Upsample(scale_factor=2), TResBlock(fin, fout,
                                                            lambda nc: TMultiSpade(nc, LABELS))]
        dec.append(tnn.Conv2d(base ** outer, 4, 3, padding=1))
        self.decode_layers = tnn.ModuleList(dec)

    def forward(self, prev_frames, prev_maps, current):
        x = prev_frames
        for layer in self.encode_layers:
            x = layer(x, prev_maps) if isinstance(layer, TResBlock) else layer(x)
        for layer in self.middle_layers:
            x = layer(x, current)
        for layer in self.decode_layers:
            x = layer(x, current) if isinstance(layer, TResBlock) else layer(x)
        return x


@pytest.mark.parametrize("pows,attention", [((2, 3, 5, 1), ("0",)), ((2, 3, 4, 2), ())],
                         ids=["tiny_attention", "extra_blocks"])
def test_sams_generator_conversion_matches_jax(rng, pows, attention):
    """(2, 3, 4, 2): encoder steps 8 -> 32 miss 16, so the last encoder and
    decoder resblocks are encode_extra and decode_extra."""
    torch.manual_seed(11)
    n_frames, B, H, W = 3, 2, 32, 24
    assert port_conv.has_extra(*pows) == (pows[3] == 2)
    tmodel = TSamsGenAny(pows, 1, [int(i) for i in attention], n_frames)
    _randomize_stats(tmodel, 2)
    with torch.no_grad():  # small kernels keep the SPADE products tame
        for name, p in tmodel.named_parameters():
            if "weight" in name and p.dim() == 4:
                p.mul_(0.1)
            if name.endswith("gamma"):
                p.fill_(0.5)
    pf = rng.randn(B, 3 * (n_frames - 1), H, W).astype(np.float32)
    pm = rng.randn(B, 2 * (n_frames - 1), H, W).astype(np.float32)
    cur = {k: rng.randn(B, c, H, W).astype(np.float32) for k, c in LABELS.items()}
    tmodel.train()
    with torch.no_grad():  # converge the power iteration, as a trained checkpoint has it
        for _ in range(30):
            tmodel(_t(pf), _t(pm), {k: _t(v) for k, v in cur.items()})
    tmodel.eval()
    with torch.no_grad():
        ref = tmodel(_t(pf), _t(pm), {k: _t(v) for k, v in cur.items()}).numpy()

    sd = {f"generator.{k}": v for k, v in tmodel.state_dict().items()}
    arch = dict(zip(("ngf_base", "ngf_pow_outer", "ngf_pow_inner", "ngf_pow_step"), pows))
    net, converted = port_conv.to_state_dict("sams", sd, arch)
    variables = jax_conv.convert_sams_generator_state_dict(sd, **arch)
    _assert_same_state_dicts(converted, convert.flax_to_state_dict(variables,
                                                                   convert.GENERATOR_RENAMES))
    kw = dict(num_middle=1, n_frames_total=n_frames, flow_warp=True, encoder_input="flow",
              inputs=tuple(sorted(LABELS)), attention_middle_indices=attention, **arch)
    gen = SamsGenerator(**kw).eval()
    gen.load_state_dict(converted, strict=True)
    nhwc = {k: v.transpose(0, 2, 3, 1) for k, v in cur.items()}
    frames = pf.reshape(B, n_frames - 1, 3, H, W).transpose(0, 1, 3, 4, 2)
    maps = pm.reshape(B, n_frames - 1, 2, H, W).transpose(0, 1, 3, 4, 2)
    with torch.no_grad():
        out = gen(_t(frames), _t(maps), {k: _t(v) for k, v in nhwc.items()}, train=False).numpy()

    from shineon_tpu.networks.sams import SamsGenerator as JSamsGenerator

    jout = JSamsGenerator(**kw).apply(jax.tree_util.tree_map(jnp.asarray, variables),
                                      jnp.asarray(frames), jnp.asarray(maps),
                                      {k: jnp.asarray(v) for k, v in nhwc.items()}, train=False)
    scale = np.abs(np.asarray(jout)).max()
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-4, atol=1e-5 * scale)
    # the JAX test's tolerance against the oracle: one more power step from u
    np.testing.assert_allclose(out, ref.transpose(0, 2, 3, 1), rtol=2e-2, atol=2e-3 * scale)


def test_lightning_cli_checkpoint_serves_the_test_entry(tmp_path):
    """A SAMS ``.ckpt`` ({"state_dict", "hyper_parameters"}) through the
    command line; ``python -m shineon_tpu_torch.test --checkpoint`` (in
    process) restores it and exports the test clips."""
    from shineon_tpu_torch import train as entry
    from shineon_tpu_torch.tools.synthetic_data import make_vvt_tree
    from shineon_tpu_torch.training.checkpointing import load_checkpoint

    torch.manual_seed(3)
    pows = (2, 3, 4, 2)
    tmodel = TSamsGenAny(pows, 1, [], 3)
    _randomize_stats(tmodel, 3)
    hp = dict(zip(("ngf_base", "ngf_pow_outer", "ngf_pow_inner", "ngf_pow_step"), pows))
    torch.save({"state_dict": {f"generator.{k}": v for k, v in tmodel.state_dict().items()},
                "hyper_parameters": hp}, tmp_path / "sams.ckpt")
    options = ["--fine_height", "32", "--fine_width", "24", "--n_frames_total", "3",
               "--num_middle", "1", "--flow_warp", "--precision", "32"]
    out = str(tmp_path / "converted")
    port_conv.main(["--model", "sams", "--ckpt", str(tmp_path / "sams.ckpt"), "--out", out,
                    *options])
    payload = load_checkpoint(out)
    assert sorted(payload["nets"]) == ["generator"] and payload["step"] == 0
    _, converted = port_conv.to_state_dict("sams", {f"generator.{k}": v for k, v in
                                                    tmodel.state_dict().items()}, hp)
    _assert_same_state_dicts(payload["nets"]["generator"]["module"], converted)

    make_vvt_tree(str(tmp_path / "vvt"), n_videos=1, frames=4, datamode="test", seed=1,
                  height=32, width=24)
    state = entry.main(False, ["--model", "sams", "--dataset", "vvt", "--name", "lightning",
                               "--vvt_dataroot", str(tmp_path / "vvt"), "--checkpoint", out,
                               "--result_dir", str(tmp_path / "res"), "--gpu_ids", "-1",
                               "--batch_size", "2", "--workers", "0",
                               *[a for k, v in hp.items() for a in (f"--{k}", str(v))],
                               *options])
    module = state.nets["generator"].module.state_dict()
    _assert_same_state_dicts({k: module[k] for k in converted}, converted)
    exported = sorted(p.name for p in (tmp_path / "res").rglob("*.png"))
    assert exported == [f"frame_{t:03d}.png" for t in range(4)]


# ------------------------------------------------------------ TrainState

SMALL_GMM = dict(fine_height=128, fine_width=96, ngf=8, precision=32, batch_size=2, workers=0)
GMM_FLAGS = ["--dataset", "viton", "--fine_height", "128", "--fine_width", "96", "--ngf", "8",
             "--precision", "32", "--batch_size", "2", "--workers", "0"]


def _dump(checkpoint, npz):
    """The README's dump of an orbax checkpoint on a host with JAX."""
    from shineon_tpu.training.checkpointing import load_checkpoint as jload

    flat = traverse_util.flatten_dict(serialization.to_state_dict(jload(checkpoint)), sep="/")
    np.savez(npz, **{k: np.asarray(v) for k, v in flat.items()})


def _jax_batch(jmodel):
    jmodel.setup("fit")
    batch = next(iter(jmodel.train_dataloader()))
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("accumulate,steps", [(1, 2), (2, 3)], ids=["adam", "multisteps"])
def test_gmm_train_state_resumes_like_jax(tmp_path, monkeypatch, accumulate, steps):
    """The JAX Trainer fits ``steps`` steps and saves FINAL with orbax; the
    port resumes from the converted checkpoint, and one more step of each
    (the same batch) agrees: the losses within 1e-5, the update counts and
    mini-steps equal, every parameter within 2 lr of the JAX one (the most
    two Adam moves can differ) and at most 1% of them more than lr / 2
    apart, at most 1% of each moment's entries more than 5% of its largest
    apart. The GMM's grid gradient jumps where a sample point crosses a
    pixel edge (ROADMAP.md §3), and at this tiny size those jumps reach
    every upstream gradient: at accumulation 2 (the mean of the loaded and
    the new gradient) 0.26% of the parameters were more than lr / 2 apart
    and 0.004% of the moments' entries beyond 5%. A state restored wrong
    (moments swapped or left at zero, the accumulator or the mini-step
    lost) moves most parameters by lr or more."""
    from shineon_tpu.models.warp_model import WarpModel as JWarpModel
    from shineon_tpu.training.checkpointing import load_checkpoint as jload
    from shineon_tpu.training.loop import Trainer as JTrainer
    from shineon_tpu_torch.models.warp_model import WarpModel
    from shineon_tpu_torch.options import gmm_options
    from shineon_tpu_torch.tools import convert_jax_state
    from shineon_tpu_torch.training.checkpointing import load_checkpoint

    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    make_viton_fixture(str(tmp_path / "viton"), n=2 * steps)
    opt = gmm_options(**SMALL_GMM, viton_dataroot=str(tmp_path / "viton"), keep_epochs=1,
                      decay_epochs=0, val_check_interval="1000000", display_count=10 ** 6,
                      name="jax", experiments_dir=str(tmp_path / "exp"),
                      accumulated_batches=accumulate)
    jmodel = JWarpModel(opt)
    JTrainer(opt).fit(jmodel)
    final = str(tmp_path / "exp" / "jax" / "checkpoints" / "named" / f"FINAL_step={steps}")
    _dump(final, tmp_path / "state.npz")
    out = str(tmp_path / "port")
    convert_jax_state.main(["--model", "gmm", "--npz", str(tmp_path / "state.npz"), "--out",
                            out, *GMM_FLAGS, "--accumulated_batches", str(accumulate)])

    batch = _jax_batch(jmodel)
    jstate = jload(final, jmodel.init_state(jax.random.PRNGKey(420), steps))
    jnew, jmetrics = jmodel.make_train_step()(jstate, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
    model = WarpModel(gmm_options(**SMALL_GMM, accumulated_batches=accumulate), "cpu")
    state = load_checkpoint(out, model.init_state(torch.Generator().manual_seed(1), steps))
    assert state.step == steps
    metrics = model.make_train_step()(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == int(jnew.step) == steps + 1
    assert abs(float(metrics["loss/G"]) - float(jmetrics["loss/G"])) <= 1e-5 * abs(
        float(jmetrics["loss/G"]))

    flat = traverse_util.flatten_dict(serialization.to_state_dict(jax.device_get(jnew)),
                                      sep="/")
    other = WarpModel(gmm_options(**SMALL_GMM, accumulated_batches=accumulate), "cpu")
    net, ref = state.nets["gmm"], convert.load_jax_train_state(flat, other.make_state(1)).nets[
        "gmm"]
    lr = 1e-4
    params = list(zip(net.module.parameters(), ref.module.parameters()))
    assert max(float((a - b).detach().abs().max()) for a, b in params) <= 2 * lr + 1e-6
    assert _share_beyond(params, lambda b: lr / 2) <= 0.01
    adam, ref_adam = net.optimizer, ref.optimizer
    if accumulate > 1:
        assert net.optimizer.mini_step == ref.optimizer.mini_step == 0  # this step updated
        assert all(not a.any() and not b.any() for a, b in zip(net.optimizer.acc,
                                                              ref.optimizer.acc))
        adam, ref_adam = net.optimizer.inner, ref.optimizer.inner
    assert adam.count == ref_adam.count == (steps + 1) // accumulate
    for slot in ("mu", "nu"):
        moments = list(zip(getattr(adam, slot), getattr(ref_adam, slot)))
        assert _share_beyond(moments, lambda b: 5e-2 * float(b.abs().max())) <= 0.01, slot


@torch.no_grad()
def _share_beyond(pairs, tolerance) -> float:
    """The share of entries whose |a - b| exceeds ``tolerance(b)``."""
    far = total = 0
    for a, b in pairs:
        far += int(((a - b).abs() > tolerance(b)).sum())
        total += a.numel()
    return far / total


def test_sams_train_state_maps_three_nets_one_to_one():
    """The tiny SAMS state of tests/test_multiprocess.py, every float leaf
    drawn anew (so that each value names its leaf): each port parameter,
    statistic, spectral u and sigma is its flax leaf, and each parameter's
    Adam moments are the moments of the same leaf; counts and step carried."""
    from __graft_entry__ import _sams_opt
    from shineon_tpu.models.sams_model import SamsModel as JSamsModel
    from shineon_tpu_torch.models.sams_model import SamsModel
    from shineon_tpu_torch.options import sams_options

    tiny = dict(fine_height=32, fine_width=24, n_frames_total=3, n_frames_now=3,
                ngf_pow_outer=3, ngf_pow_inner=4, num_middle=1, ndf=8, n_layers_D=2,
                batch_size=4)
    jstate = JSamsModel(_sams_opt(**tiny)).init_state(jax.random.PRNGKey(420), 4)
    flat = traverse_util.flatten_dict(serialization.to_state_dict(jax.device_get(jstate)),
                                      sep="/")
    rng = np.random.RandomState(0)
    flat = {k: (np.asarray(rng.randn(*np.shape(v)), np.float32)
                if np.asarray(v).dtype == np.float32 else np.asarray(v) + 3)
            for k, v in flat.items()}
    model = SamsModel(sams_options(**tiny, is_train=True, precision=32), "cpu")
    state = convert.load_jax_train_state(flat, model.make_state(4))
    assert sorted(state.nets) == ["d_multi", "d_temporal", "generator"] and state.step == 3
    spectral = 0
    for name, net in state.nets.items():
        assert net.optimizer.count == 3
        values = {}  # a parameter's flax leaf by its (unique) values
        for key, value in flat.items():
            if key.startswith(f"nets/{name}/params/"):
                t = convert._torch_value(key.split("/"), value)
                values[t.numpy().tobytes()] = key
        names = [n for n, _ in net.module.named_parameters()]
        for i, (pname, p) in enumerate(net.module.named_parameters()):
            key = values[p.detach().numpy().tobytes()]
            for slot, j in (("mu", 0), ("nu", 0)):
                theirs = flat[key.replace("/params/", f"/opt_state/{j}/{slot}/", 1)]
                assert torch.equal(getattr(net.optimizer, slot)[i],
                                   convert._torch_value(key.split("/"), theirs)), (pname, slot)
        assert len(values) == len(names)
        buffers = dict(net.module.named_buffers())
        for bname, b in buffers.items():
            spectral += bname.endswith((".u", ".sigma"))
            assert not torch.equal(b, torch.zeros_like(b)), bname  # every buffer was filled
    assert spectral > 0


# ----------------------------------------------------------------- VGG19

def test_vgg19_npz_matches_jax_tool(tmp_path, monkeypatch):
    """A random VGG19 ``state_dict`` with torchvision's keys (the features'
    convs, ReLUs and pools, the classifier) saved as ``.pth``: the port's
    ``.npz`` holds the JAX tool's entries, bit for bit, and
    ``load_vgg19`` reads it through SHINEON_VGG19_WEIGHTS."""
    from shineon_tpu.networks.vgg import convert_torch_vgg19_state_dict, save_vgg19_params
    from shineon_tpu_torch.networks.vgg import load_vgg19
    from shineon_tpu_torch.tools import convert_vgg19

    g = torch.Generator().manual_seed(5)
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M",
           512, 512, 512, 512, "M"]
    sd, cin, i = {}, 3, 0
    for c in cfg:
        if c == "M":
            i += 1
            continue
        sd[f"features.{i}.weight"] = torch.randn(c, cin, 3, 3, generator=g)
        sd[f"features.{i}.bias"] = torch.randn(c, generator=g)
        cin, i = c, i + 2
    sd["classifier.0.weight"] = torch.randn(8, 16, generator=g)
    torch.save(sd, tmp_path / "vgg19.pth")
    convert_vgg19.main([str(tmp_path / "vgg19.pth"), str(tmp_path / "port.npz")])
    save_vgg19_params(convert_torch_vgg19_state_dict({k: v.numpy() for k, v in sd.items()}),
                      str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as out, np.load(tmp_path / "jax.npz") as ref:
        assert sorted(out.files) == sorted(ref.files) and len(out.files) == 26
        for key in ref.files:
            assert out[key].dtype == ref[key].dtype and np.array_equal(out[key], ref[key]), key
    monkeypatch.setenv("SHINEON_VGG19_WEIGHTS", str(tmp_path / "port.npz"))
    model = load_vgg19()
    assert torch.equal(model.convs[12].weight, sd["features.28.weight"])
    assert osp.exists(tmp_path / "port.npz")
