"""The port's flow annotation against the JAX package on the CPU, f32: the
cost volume, the channel norm and the bilinear resize; FlowNetC, FlowNetS,
FlowNetSD and FlowNetFusion at 64x64 and the whole FlowNet2, each against
its flax module with weights carried across by
``convert.flownet2_state_dict``; the FlowNet wrapper (flow and confidence)
at 64x64 and at 100x72, which it resizes to 128x128 and back; the ``.flo``
bytes; and ``generate_flow_annotations`` over a folder of PNG frames.

The flax weights are drawn once for the module from a numpy seed (uniform
with the variance of flax's lecun normal, small nonzero biases, the
``upsampled_flow*`` biases zero as flax initialises them), and the port
reads them from a checkpoint file in the published layout, written in
torch's legacy format as the released file is.

Tolerances: the sub-networks at the golden file's rtol 2e-3, atol 2e-5
(tests/test_flownet_golden.py); FlowNet2 and the wrapper's flow at its rtol
5e-3, atol 5e-4; the cost volume and the channel norm at f32 rounding of a
sum in another order (rtol 1e-5, atol 1e-6); the resize at rtol 1e-6, atol
1e-4 on values up to 255 (a few f32 ulps)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from shineon_tpu.datasets import flow_utils as jax_flow_utils
from shineon_tpu.models import flownet as jax_flownet
from shineon_tpu.networks import flownet as jax_nets
from shineon_tpu.ops.correlation import cost_volume as jax_cost_volume
from shineon_tpu.ops.image_ops import channel_norm as jax_channel_norm
from shineon_tpu_torch.convert import flownet2_state_dict
from shineon_tpu_torch.datasets import flow_utils
from shineon_tpu_torch.models.flownet import FlowNet, build_flownet2, generate_flow_annotations
from shineon_tpu_torch.networks.flownet import FlowNet2
from shineon_tpu_torch.ops.correlation import cost_volume
from shineon_tpu_torch.ops.image_ops import channel_norm, resize_bilinear
from test_flownet_golden import TorchFlowNet2
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)

SUBNET_TOL = dict(rtol=2e-3, atol=2e-5)
STACK_TOL = dict(rtol=5e-3, atol=5e-4)
REDUCE_TOL = dict(rtol=1e-5, atol=1e-6)
RESIZE_TOL = dict(rtol=1e-6, atol=1e-4)
# flipped confidence pixels allowed: a squared warp error within f32 noise
# of the 0.02 threshold may land on either side
MAX_FLIP_SHARE = 1e-3


def _random_params(seed):
    """The JAX FlowNet2's params tree with seeded numpy values."""
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(jax_nets.FlowNet2().init, jax.random.PRNGKey(0), x, x)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            limit = np.sqrt(3.0 / np.prod(leaf.shape[:-1]))  # lecun normal's variance
            return ((rng.random(leaf.shape, dtype=np.float32) * 2 - 1) * limit).astype(np.float32)
        if "upsampled_flow" in name:
            return np.zeros(leaf.shape, np.float32)
        return ((rng.random(leaf.shape, dtype=np.float32) - 0.5) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def flownet(tmp_path_factory):
    """(flax params, the port's FlowNet2 holding them on the CPU, a
    checkpoint file of them), built once for the module."""
    params = _random_params(9)
    net = build_flownet2(None, "cpu")
    net.load_state_dict(flownet2_state_dict(params), strict=True)
    path = str(tmp_path_factory.mktemp("flownet2") / "FlowNet2_checkpoint.pth.tar")
    torch.save({"arch": "FlowNet2", "epoch": 0, "best_EPE": 1e10, "state_dict": net.state_dict()},
               path, _use_new_zipfile_serialization=False)
    yield params, net, path
    jax.clear_caches()


def _frames(rng, shape):
    """A uint8 frame pair: smooth colour waves with noise, and the same
    frame moved one pixel right with new noise."""
    B, H, W, _ = shape
    y, x = np.mgrid[0:H, 0:W + 1].astype(np.float32)
    phase = rng.rand(B, 1, 1, 3) * 6.28
    wave = 128 + 90 * np.sin(x[None, ..., None] / 6 + y[None, ..., None] / 9 + phase)

    def noisy(im):
        return np.clip(im + rng.randn(*im.shape) * 4, 0, 255).astype(np.uint8)

    return noisy(wave[:, :, 1:]), noisy(wave[:, :, :-1])


@pytest.mark.parametrize("B,H,W,C,md,stride", [(2, 8, 8, 4, 4, 1), (1, 12, 10, 16, 20, 2)],
                         ids=["md4_s1", "md20_s2"])
def test_cost_volume_matches_jax(B, H, W, C, md, stride):
    """md 4, stride 1 (81 channels) and FlowNetC's md 20, stride 2 (441
    channels, wider than the 12x10 map: most windows read padding)."""
    rng = np.random.RandomState(1)
    f1, f2 = (rng.randn(B, H, W, C).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_cost_volume(jnp.asarray(f1), jnp.asarray(f2), md, stride))
    got = cost_volume(torch.from_numpy(f1), torch.from_numpy(f2), md, stride).numpy()
    assert got.shape == want.shape == (B, H, W, (2 * (md // stride) + 1) ** 2)
    np.testing.assert_allclose(got, want, **REDUCE_TOL)


def test_channel_norm_matches_jax():
    x = np.random.RandomState(2).randn(2, 9, 7, 5).astype(np.float32)
    want = np.asarray(jax_channel_norm(jnp.asarray(x)))
    got = channel_norm(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 9, 7, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **REDUCE_TOL)


@pytest.mark.parametrize("shape,size,method", [
    ((2, 16, 12, 2), (64, 48), "linear"),  # FlowNet2's x4 flow upsampling
    ((1, 100, 72, 3), (128, 128), "bilinear"),  # frames up to multiples of 64
    ((1, 128, 128, 2), (100, 72), "bilinear"),  # the flow back down: antialiased
], ids=["x4_up", "up_to_64", "down_antialias"])
def test_resize_bilinear_matches_jax(shape, size, method):
    """Every pixel, the borders too: upsampling, JAX renormalises the
    triangle weights that fall off the edge, which is PyTorch's clamp of the
    source coordinate; downsampling, both widen the kernel by the scale."""
    x = (np.random.RandomState(3).rand(*shape) * 255).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, shape[3]), method=method))
    got = resize_bilinear(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(got, want, **RESIZE_TOL)


@pytest.mark.parametrize("name", ["flownetc", "flownets1", "flownets_d", "flownetfusion"])
def test_subnetwork_matches_flax(flownet, name):
    params, net, _ = flownet
    flax_module, port, channels = {
        "flownetc": (jax_nets.FlowNetC(), net.flownetc, (3, 3)),
        "flownets1": (jax_nets.FlowNetS(), net.flownets_1, (12,)),
        "flownets_d": (jax_nets.FlowNetSD(), net.flownets_d, (6,)),
        "flownetfusion": (jax_nets.FlowNetFusion(), net.flownetfusion, (11,)),
    }[name]
    rng = np.random.RandomState(4)
    xs = [(rng.randn(1, 64, 64, c) * 0.5).astype(np.float32) for c in channels]
    want = np.asarray(jax.jit(flax_module.apply)({"params": params[name]}, *xs))
    with torch.no_grad():
        got = port(*map(torch.from_numpy, xs)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **SUBNET_TOL)


def test_flownet2_matches_flax(flownet):
    params, net, _ = flownet
    im1, im2 = (a.astype(np.float32) for a in _frames(np.random.RandomState(5), (2, 64, 64, 3)))
    want = np.asarray(jax.jit(jax_nets.FlowNet2().apply)({"params": params}, im1, im2))
    with torch.no_grad():
        got = net(torch.from_numpy(im1), torch.from_numpy(im2)).numpy()
    assert got.shape == (2, 64, 64, 2)
    np.testing.assert_allclose(got, want, **STACK_TOL)


@pytest.mark.parametrize("H,W", [(64, 64), (100, 72)])
def test_flownet_matches_jax(flownet, H, W, monkeypatch):
    """Flow and confidence of the wrapper, the port's weights read from the
    checkpoint file that SHINEON_FLOWNET2_WEIGHTS names, the JAX package's
    given the same params; at 100x72 both resize to 128x128 and back."""
    params, _, path = flownet
    monkeypatch.setattr(jax_flownet.FlowNet, "_load", lambda self, *_: {"params": params})
    monkeypatch.setenv("SHINEON_FLOWNET2_WEIGHTS", path)
    im1, im2 = _frames(np.random.RandomState(6), (2, H, W, 3))
    want_flow, want_conf = jax_flownet.FlowNet()(im1, im2)
    flow, conf = FlowNet(device="cpu")(im1, im2)
    assert flow.shape == (2, H, W, 2) and conf.shape == (2, H, W, 1)
    np.testing.assert_allclose(flow.numpy(), want_flow, **STACK_TOL)
    assert set(np.unique(conf.numpy())) <= {0.0, 1.0}
    flips = int((conf.numpy() != want_conf).sum())
    assert flips <= MAX_FLIP_SHARE * conf.numel(), f"{flips} confidence pixels differ"
    assert 0 < want_conf.sum() < want_conf.size  # the threshold splits the pixels


def test_flo_bytes_match_jax(tmp_path):
    """The port's .flo file is byte for byte the JAX package's, for f32,
    f64 and non-contiguous input; both readers give back the same bits;
    the colour coding is the same."""
    rng = np.random.RandomState(7)
    flow = rng.randn(9, 13, 2).astype(np.float32) * 10
    for i, f in enumerate((flow, flow.astype(np.float64), flow.transpose(1, 0, 2))):
        ours, theirs = tmp_path / f"ours{i}.flo", tmp_path / f"theirs{i}.flo"
        flow_utils.write_flow(str(ours), f)
        jax_flow_utils.write_flow(str(theirs), f)
        assert ours.read_bytes() == theirs.read_bytes()
        back = flow_utils.read_flow(str(ours))
        assert back.dtype == np.float32 and back.shape == f.shape
        assert back.tobytes() == np.asarray(f, np.float32).tobytes()
        assert jax_flow_utils.read_flow(str(ours)).tobytes() == back.tobytes()
    flow[0, 0] = np.nan
    assert np.array_equal(flow_utils.flow_to_image(flow), jax_flow_utils.flow_to_image(flow))
    (tmp_path / "bad.flo").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="magic"):
        flow_utils.read_flow(str(tmp_path / "bad.flo"))


def test_generate_flow_annotations_matches_jax(flownet, tmp_path, monkeypatch):
    """Two videos of three PNG frames, pairs in batches of two: the same
    .flo files as the JAX function, flows within FlowNet's tolerance; the
    port's weights from the checkpoint file passed as an argument."""
    params, _, path = flownet
    rng = np.random.RandomState(8)
    for video in ("vid_a", "vid_b"):
        os.makedirs(tmp_path / "frames" / video)
        frames = _frames(rng, (1, 64, 64, 3))
        for t, im in enumerate((frames[0][0], frames[1][0], np.roll(frames[1][0], 1, axis=0))):
            Image.fromarray(im).save(tmp_path / "frames" / video / f"frame_{t:03d}.png")
    (tmp_path / "frames" / "notes.txt").write_text("not a video")
    monkeypatch.setattr(jax_flownet.FlowNet, "_load", lambda self, *_: {"params": params})
    n_jax = jax_flownet.generate_flow_annotations(
        str(tmp_path / "frames"), str(tmp_path / "jax"), batch_size=2)
    n = generate_flow_annotations(str(tmp_path / "frames"), str(tmp_path / "port"), path,
                                  batch_size=2, device="cpu")
    names = sorted(str(p.relative_to(tmp_path / "port")) for p in (tmp_path / "port").rglob("*"))
    want = sorted(str(p.relative_to(tmp_path / "jax")) for p in (tmp_path / "jax").rglob("*"))
    assert n == n_jax == 4 and names == want
    for name in names:
        if name.endswith(".flo"):
            np.testing.assert_allclose(flow_utils.read_flow(str(tmp_path / "port" / name)),
                                       flow_utils.read_flow(str(tmp_path / "jax" / name)),
                                       **STACK_TOL)


def test_state_dict_layout_is_the_published_checkpoints():
    """The port's keys and shapes are the flownet2-pytorch checkpoint's (the
    golden file's oracle), so its state_dict loads with strict=True."""
    with torch.device("meta"):
        ours = {k: tuple(v.shape) for k, v in FlowNet2().state_dict().items()}
        published = {k: tuple(v.shape) for k, v in TorchFlowNet2().state_dict().items()}
    assert ours == published
    assert sum(np.prod(s) for s in ours.values()) == 162_518_814


def test_flax_map_covers_every_key_and_refuses_nonzero_upsampling_bias(flownet):
    params, net, _ = flownet
    mapped = flownet2_state_dict(params)
    assert mapped.keys() == net.state_dict().keys()
    bad = {**params, "flownetc": {**params["flownetc"], "refine": {
        **params["flownetc"]["refine"], "upsampled_flow6_to_5": {
            **params["flownetc"]["refine"]["upsampled_flow6_to_5"],
            "bias": np.array([0.0, 1e-3], np.float32)}}}}
    with pytest.raises(ValueError, match="upsampled_flow6_to_5"):
        flownet2_state_dict(bad)


def test_random_weights_follow_flax_init(caplog, monkeypatch):
    """Without a checkpoint FlowNet warns and draws flax's init from its
    seed: lecun normal kernels (a deconv's fan_in from its input channels),
    zero biases."""
    monkeypatch.delenv("SHINEON_FLOWNET2_WEIGHTS", raising=False)
    with caplog.at_level("WARNING"):
        net = FlowNet(device="cpu", seed=3).model
    assert "RANDOM weights" in caplog.text
    sd = net.state_dict()
    for key, fan_in in (("flownetc.conv6_1.0.weight", 1024 * 9),
                        ("flownets_d.deconv5.0.weight", 1024 * 16),
                        ("flownetfusion.deconv0.0.weight", 162 * 16)):
        assert abs(sd[key].std().item() * np.sqrt(fan_in) - 1.0) < 0.1, key
    assert all(sd[k].abs().max() == 0 for k in sd if k.endswith("bias"))


def test_flownet_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FlowNet()
