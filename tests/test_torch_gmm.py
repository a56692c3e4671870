"""The port's GMM training against the JAX package on the CPU, f32:
cocopose heatmaps and features, grid_sample's gradient (the JAX custom
VJP, points exactly on the borders included), the GMM's loss, gradient,
batch statistics and one Adam step, and its validation and visual steps.
The GMM's weights are made by the JAX package's ``init_state`` and carried
across with shineon_tpu_torch.convert; inputs come from a numpy seed. The
GMM runs at 128x96, the smallest fine size its regression tower takes,
with ngf 8 and batch 2.

The ``gpu``-marked test at the end runs grid_sample's backward on the card
(it skips here) and needs no JAX: ``python3 -m pytest --noconftest
tests/test_torch_gmm.py -m gpu -q``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from shineon_tpu_torch import convert
from shineon_tpu_torch.datasets.preprocess import PreprocessConfig, preprocess_batch
from shineon_tpu_torch.models.warp_model import WarpModel
from shineon_tpu_torch.ops import grid_sample
from shineon_tpu_torch.ops.image_ops import pose_keypoint_heatmaps
from shineon_tpu_torch.options import gmm_options, sams_options
from shineon_tpu_torch.serving import synthetic_raw_batch

try:  # every test but the gpu-marked one; the card's machine has no JAX
    import jax
    import jax.numpy as jnp
    import optax

    import shineon_tpu.ops as jops
    from shineon_tpu.datasets.preprocess import PreprocessConfig as JConfig
    from shineon_tpu.datasets.preprocess import preprocess_batch as j_preprocess
    from shineon_tpu.models.warp_model import WarpModel as JWarpModel
    from shineon_tpu.ops.image_ops import pose_keypoint_heatmaps as j_pose_keypoint_heatmaps
    from shineon_tpu.options.base_options import namespace_from_defaults
    from test_torch_networks import _np, one_torch_thread  # noqa: F401
    from test_torch_training import adam_step_flips, state_dict_of
except ImportError:
    pass

SMALL_GMM = dict(fine_height=128, fine_width=96, ngf=8, precision=32, batch_size=2)
STEPS_PER_EPOCH = 4
STATS = ("running_mean", "running_var")


def _plain(value):
    return list(value) if isinstance(value, (list, tuple)) else value


def test_gmm_options_match_jax_defaults():
    """gmm_options is the JAX package's `--model warp` configuration of
    docs/3_train.md; an unknown key raises."""
    ref = namespace_from_defaults("warp", "viton")
    opt = gmm_options()
    for key in ("person_inputs", "cloth_inputs", "fine_height", "fine_width", "radius",
                "batch_size", "ngf", "grid_size", "precision", "lr", "keep_epochs",
                "decay_epochs", "accumulated_batches", "flow_warp"):
        assert _plain(getattr(opt, key)) == _plain(getattr(ref, key)), key
    with pytest.raises(ValueError, match="unknown options"):
        gmm_options(num_D=2)


# ---------------------------------------------------------------- cocopose

def test_pose_keypoint_heatmaps_match_jax():
    """The 18 square stamps and their union, exactly (values -1 and +1),
    over leading (batch, frames) dims: joints inside the frame, on its
    edges, half outside, fractional, and skipped ones (x <= 1 or y <= 1)."""
    rng = np.random.RandomState(0)
    kp = (rng.rand(2, 3, 18, 3) * np.array([40, 30, 1], np.float32)).astype(np.float32)
    kp[0, 0, :6, :2] = [[1.0, 9.0], [9.0, 1.0], [1.5, 1.5], [0.0, 0.0], [39.9, 29.9],
                        [-3.0, 12.0]]
    kp[1, 2, :3, :2] = [[45.0, 10.0], [10.0, 33.5], [2.0, 2.0]]
    ref_map, ref_vis = j_pose_keypoint_heatmaps(jnp.asarray(kp), 30, 40, 3)
    pose_map, vis = pose_keypoint_heatmaps(torch.from_numpy(kp), 30, 40, 3)
    assert pose_map.shape == (2, 3, 30, 40, 18) and vis.shape == (2, 3, 30, 40, 1)
    np.testing.assert_array_equal(pose_map.numpy(), np.asarray(ref_map))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(ref_vis))
    assert (pose_map[0, 0, ..., 0] == -1).all() and (pose_map[0, 0, ..., 2] == 1).any()


def test_preprocess_cocopose_matches_jax():
    """The GMM's features (agnostic + cocopose, the grid image) from the
    port's synthetic raw batch: every key of the JAX package's features,
    within 1e-6 (cocopose and im_cocopose exactly)."""
    opt = gmm_options(fine_height=64, fine_width=48)
    raw = {k: v.numpy() for k, v in synthetic_raw_batch(opt, 2, seed=3).items()}
    ref = j_preprocess({k: jnp.asarray(v) for k, v in raw.items()}, JConfig.from_opt(opt))
    out = preprocess_batch({k: torch.from_numpy(v) for k, v in raw.items()},
                           PreprocessConfig.from_opt(opt))
    assert sorted(out) == sorted(ref) and {"cocopose", "im_cocopose", "grid_vis"} <= set(out)
    assert out["cocopose"].shape == (2, 1, 64, 48, 18)
    assert (out["cocopose"] == 1).any()
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=0,
                                   atol=0 if "cocopose" in key else 1e-6, err_msg=key)


def test_synthetic_raw_batch_adds_keypoints_only_when_asked():
    """The SAMS batch is unchanged (the keys the JAX package's _raw_batch
    draws, value for value); keypoints and the grid image come after them,
    for the GMM's options only."""
    from __graft_entry__ import _raw_batch, _sams_opt

    sams = synthetic_raw_batch(sams_options(fine_height=16, fine_width=12), 2, seed=1)
    ref = _raw_batch(_sams_opt(fine_height=16, fine_width=12), batch=2, rng_seed=1)
    assert sorted(sams) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sams[k].numpy(), v)
    gmm = synthetic_raw_batch(gmm_options(fine_height=16, fine_width=12), 2, seed=1)
    assert gmm["cocopose_kp"].shape == (2, 1, 18, 3)
    assert gmm["grid_vis_u8"].shape == (2, 1, 16, 12, 3)
    kp = gmm["cocopose_kp"].numpy()
    assert kp[..., 0].max() < 12 and kp[..., 1].max() < 16 and kp[..., 2].max() < 1


# ------------------------------------------------------- grid_sample's VJP

def _border_grid(rng, ac, H, W):
    """A grid reaching past [-1, 1], with rows of points exactly on the
    first and last pixel centres of each axis."""
    grid = rng.uniform(-1.3, 1.3, (2, 4, 6, 2)).astype(np.float32)

    def centre(p, size):
        return np.float32(2 * p / (size - 1) - 1 if ac else (2 * p + 1) / size - 1)

    grid[0, 0, :, 0], grid[0, 1, :, 0] = centre(0, W), centre(W - 1, W)
    grid[0, 2, :, 1], grid[0, 3, :, 1] = centre(0, H), centre(H - 1, H)
    grid[1, 0, :, :] = [centre(0, W), centre(0, H)]
    return grid


def _jax_grads(img, grid, g, mode, ac):
    f = lambda i, gr: jnp.sum(jops.grid_sample(i, gr, padding_mode=mode,  # noqa: E731
                                               align_corners=ac) * g)
    return jax.grad(f, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(grid))


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_gradient_matches_jax_vjp(padding_mode, align_corners):
    """d image and d grid of sum(grid_sample(image, grid) * g) against the
    JAX package's custom VJP, grid points exactly on the first and last
    pixel centres included: each within 1e-5 of its largest entry."""
    rng = np.random.RandomState(4)
    H, W = 5, 7
    img = rng.randn(2, H, W, 3).astype(np.float32)
    grid = _border_grid(rng, align_corners, H, W)
    g = rng.randn(2, 4, 6, 3).astype(np.float32)
    ji, jg = _jax_grads(img, grid, g, padding_mode, align_corners)
    ti = torch.from_numpy(img).requires_grad_()
    tg = torch.from_numpy(grid).requires_grad_()
    (grid_sample(ti, tg, padding_mode, align_corners) * torch.from_numpy(g)).sum().backward()
    for out, ref in ((ti.grad, ji), (tg.grad, jg)):
        ref = np.asarray(ref)
        assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_torch_border_gradient_differs_from_jax_vjp():
    """What the port's backward repairs: PyTorch's own autograd of
    F.grid_sample (border, align_corners) zeroes the grid gradient of points
    exactly on the first pixel centre, which the JAX VJP keeps. resample2d
    with zero flow at column 0 is such a grid."""
    rng = np.random.RandomState(4)
    H, W = 5, 7
    img = rng.randn(2, H, W, 3).astype(np.float32)
    grid = _border_grid(rng, True, H, W)
    g = rng.randn(2, 4, 6, 3).astype(np.float32)
    _, jg = _jax_grads(img, grid, g, "border", True)
    tg = torch.from_numpy(grid).requires_grad_()
    out = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2), tg, padding_mode="border",
                        align_corners=True).permute(0, 2, 3, 1)
    (out * torch.from_numpy(g)).sum().backward()
    jg = np.asarray(jg)
    diff = np.abs(tg.grad.numpy() - jg)
    assert diff.max() > 0.1 * np.abs(jg).max()
    assert (tg.grad[0, 0, :, 0] == 0).all() and (np.abs(jg[0, 0, :, 0]) > 0).all()


# ------------------------------------------------------------------- GMM

class JaxGmm:
    """A JAX WarpModel at SMALL_GMM, its initial state in numpy and the raw
    batch (the port's synthetic one)."""

    def __init__(self):
        self.opt = gmm_options(**SMALL_GMM)
        self.model = JWarpModel(self.opt)
        self.state = self.model.init_state(jax.random.PRNGKey(11), STEPS_PER_EPOCH)
        net = self.state.nets["gmm"]
        self.variables = {"params": _np(net.params), **_np(net.stats)}
        self.raw = {k: v.numpy() for k, v in synthetic_raw_batch(self.opt, 2, seed=5).items()}
        self.batch = {k: jnp.asarray(v) for k, v in self.raw.items()}

    def port(self):
        model = WarpModel(self.opt, device="cpu")
        convert.load_flax(model.gmm, self.variables, convert.GMM_RENAMES)
        state = model.make_state(STEPS_PER_EPOCH)
        return model, state, {k: torch.from_numpy(v) for k, v in self.raw.items()}


@pytest.fixture(scope="module")
def gmm():
    return JaxGmm()


def _jax_loss_and_grad(side, port_grid):
    """The JAX package's GMM loss (``_forward_loss``, train mode), and its
    gradient with the sampling done at ``port_grid``: the JAX grid plus the
    stop-gradient of its difference from the port's. A bilinear sample's
    grid gradient jumps where a point crosses a pixel edge, and the two
    frameworks' grids differ by f32 rounding (about 1e-5 pixel here): the
    few points that straddle an edge move the TPS parameters' gradient by
    several percent at random weights and uint8-noise images. Sampled at
    the same points, the two gradients differ by rounding only.
    Returns (loss, new batch statistics, gradient)."""
    from shineon_tpu.networks.loss import l1_loss as j_l1_loss
    from shineon_tpu.utils import get_and_cat_inputs

    model, net = side.model, side.state.nets["gmm"]
    loss, _ = jax.jit(lambda p, b: model._forward_loss(p, net.stats, model.features(b),
                                                       train=True))(net.params, side.batch)

    @jax.jit
    def grad(params, batch, port_grid):
        feats = model.features(batch)
        person = get_and_cat_inputs(feats, side.opt.person_inputs)
        cloth_in = get_and_cat_inputs(feats, side.opt.cloth_inputs)

        def f(p):
            (grid, _), new_stats = model.gmm.apply(
                {"params": p, **net.stats}, person, cloth_in, train=True,
                mutable=["batch_stats"])
            grid = grid + jax.lax.stop_gradient(port_grid - grid)
            warped = jops.grid_sample(feats["cloth"], grid, padding_mode="border")
            return j_l1_loss(warped, feats["im_cloth"]), new_stats

        return jax.value_and_grad(f, has_aux=True)(params)

    (_, new_stats), grads = grad(net.params, side.batch, port_grid)
    return loss, new_stats, grads


def test_gmm_train_step_matches_jax(gmm):
    """One GMM training step from the same state: the loss within 1e-4 of
    the JAX package's; the gradient of every parameter (grid_sample's VJP,
    the TPS products, the correlation and the batch-norm towers) within
    1e-3 of the tensor's largest entry, against the JAX gradient sampled at
    the port's grid points (_jax_loss_and_grad); the running statistics
    within 1e-4; the Adam step (optax on that gradient) within 1e-3 lr of
    every entry, apart from sign flips at a gradient within f32 noise of
    0, which are counted (at most 0.1%)."""
    model, state, raw = gmm.port()
    named = dict(model.gmm.named_parameters())
    loss, grid, *_ = model.forward_loss(model.features(raw), train=True)
    loss, grid = loss, grid.detach()
    grads = dict(zip(named, (g.numpy() for g in torch.autograd.grad(loss, list(named.values())))))
    jloss, jstats, jgrads = _jax_loss_and_grad(gmm, grid.numpy())
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-4 * abs(float(jloss))
    ref = state_dict_of({"params": _np(jgrads)}, convert.GMM_RENAMES)
    assert sorted(ref) == sorted(grads)
    largest = max(np.abs(r).max() for r in ref.values())
    zero = sorted(n for n, r in ref.items() if np.abs(r).max() <= 1e-5 * largest)
    # the regression's conv biases feed a batch norm: their exact gradient
    # is 0, and both frameworks give f32 noise there
    assert zero == [f"regression.convs.{i}.bias" for i in range(4)], zero
    for name, r in ref.items():
        if name in zero:
            assert np.abs(grads[name]).max() <= 1e-5 * largest, name
        else:
            assert np.abs(grads[name] - r).max() <= 1e-3 * np.abs(r).max(), name

    params = gmm.state.nets["gmm"].params
    updates, _ = gmm.model._tx.update(jgrads, gmm.state.nets["gmm"].opt_state, params)
    jnew = optax.apply_updates(params, updates)
    model, state, raw = gmm.port()
    before = {k: v.clone().numpy() for k, v in model.gmm.state_dict().items()}
    metrics = model.make_train_step()(state, raw)
    assert state.step == 1 and metrics["lr"] == gmm.opt.lr
    assert abs(float(metrics["loss/G"]) - float(jloss)) <= 1e-4 * abs(float(jloss))
    ref = state_dict_of({"params": _np(jnew), **_np(jstats)}, convert.GMM_RENAMES)
    mine = {k: v.numpy() for k, v in model.gmm.state_dict().items()}
    assert sorted(ref) == sorted(mine)
    flipped = total = 0
    for key, r in ref.items():
        if key.endswith(STATS):
            assert np.abs(mine[key] - r).max() <= 1e-4 * np.abs(r).max(), key
            assert not np.array_equal(mine[key], before[key]), key
        else:
            flipped += adam_step_flips(before[key], mine[key], r, gmm.opt.lr, key)
            total += r.size
    assert flipped <= 1e-3 * total, (flipped, total)


def test_grid_sample_gradient_at_the_gmm_grid_matches_jax(gmm):
    """grid_sample's backward at the GMM's own grid, cloth and L1 target
    (its train-mode forward from the JAX state), the sampling points the
    step's gradient goes through: d grid and d cloth within 1e-5 of their
    largest entries."""
    from shineon_tpu.networks.loss import l1_loss as j_l1_loss

    model, _, raw = gmm.port()
    feats = model.features(raw)
    with torch.no_grad():
        grid, _ = model.gmm(torch.cat([feats["agnostic"], feats["cocopose"]], dim=-1),
                            feats["cloth"], train=True)
    cloth, target = feats["cloth"].numpy(), feats["im_cloth"].numpy()
    ji, jg = jax.grad(lambda c, g: j_l1_loss(jops.grid_sample(c, g, padding_mode="border"),
                                             target), argnums=(0, 1))(cloth, grid.numpy())
    tc = torch.from_numpy(cloth).requires_grad_()
    tg = grid.clone().requires_grad_()
    (grid_sample(tc, tg, "border") - torch.from_numpy(target)).abs().mean().backward()
    for out, ref in ((tc.grad, ji), (tg.grad, jg)):
        ref = np.asarray(ref)
        assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_gmm_val_and_visual_steps_match_jax(gmm):
    """The eval-mode loss and checkpoint_on within 1e-4, and every tensor
    of the visual step (the warped cloth, the grid image warped with zeros
    padding, the inputs) within 1e-4 of its largest entry; neither step
    changes the running statistics."""
    jval = gmm.model.make_val_step()(gmm.state, gmm.batch)
    jvis = gmm.model.make_visual_step()(gmm.state, gmm.batch)
    model, state, raw = gmm.port()
    before = {k: v.clone() for k, v in model.gmm.state_dict().items()}
    val = model.make_val_step()(state, raw)
    vis = model.make_visual_step()(state, raw)
    assert sorted(val) == sorted(jval)
    for k, r in jval.items():
        assert abs(float(val[k]) - float(r)) <= 1e-4 * abs(float(r)), k
    assert sorted(vis) == sorted(jvis)
    for k, r in jvis.items():
        r = np.asarray(r)
        assert vis[k].shape == r.shape, k
        assert np.abs(vis[k].numpy() - r).max() <= 1e-4 * max(np.abs(r).max(), 1.0), k
    assert all(torch.equal(v, model.gmm.state_dict()[k]) for k, v in before.items())


@pytest.mark.gpu
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_gradient_on_card_matches_cpu(padding_mode):
    """grid_sample's backward (the JAX VJP, its d image a scatter-add) on
    the card against the CPU at a GMM-sized warp (8 x 256 x 192 x 3, a
    grid reaching past [-1, 1] with rows on the first and last pixel
    centres): d image and d grid within 1e-5 of their largest entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    H, W = 256, 192
    img = torch.from_numpy(rng.randn(8, H, W, 3).astype(np.float32))
    grid = rng.uniform(-1.1, 1.1, (8, H, W, 2)).astype(np.float32)
    grid[:, 0, :, 0], grid[:, 1, :, 0] = 1 / W - 1, 1 - 1 / W
    grid = torch.from_numpy(grid)
    g = torch.from_numpy(rng.randn(8, H, W, 3).astype(np.float32))
    results = []
    for device in ("cuda", "cpu"):
        ti, tg = img.to(device).requires_grad_(), grid.to(device).requires_grad_()
        out = grid_sample(ti, tg, padding_mode)
        results.append([t.cpu() for t in torch.autograd.grad((out * g.to(device)).sum(),
                                                             [ti, tg])])
    for card, cpu in zip(*results):
        assert (card - cpu).abs().max() <= 1e-5 * cpu.abs().max()
