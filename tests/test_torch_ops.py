"""The port's ops (shineon_tpu_torch/ops, datasets/preprocess.py) against
the JAX package on the CPU, same numpy inputs, f32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import shineon_tpu.ops as jops
from __graft_entry__ import _raw_batch, _sams_opt
from shineon_tpu.datasets.preprocess import PreprocessConfig as JConfig
from shineon_tpu.datasets.preprocess import preprocess_batch as j_preprocess
import shineon_tpu_torch.ops as tops
from shineon_tpu_torch.datasets.preprocess import PreprocessConfig as TConfig
from shineon_tpu_torch.datasets.preprocess import preprocess_batch as t_preprocess


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample(padding_mode, align_corners):
    """Grids reach past [-1, 1] so both padding rules matter: atol 1e-5."""
    rng = np.random.RandomState(0)
    img = rng.randn(2, 9, 7, 3).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 5, 6, 2)).astype(np.float32)
    ref = jops.grid_sample(jnp.asarray(img), jnp.asarray(grid),
                           padding_mode=padding_mode, align_corners=align_corners)
    out = tops.grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                           padding_mode=padding_mode, align_corners=align_corners)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_resample2d():
    """Pixel-unit flow warp with border clamping: atol 1e-5."""
    rng = np.random.RandomState(1)
    img = rng.randn(2, 12, 10, 3).astype(np.float32)
    flow = (3.0 * rng.randn(2, 12, 10, 2)).astype(np.float32)
    ref = jops.resample2d(jnp.asarray(img), jnp.asarray(flow))
    out = tops.resample2d(torch.from_numpy(img), torch.from_numpy(flow))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_tps_grid_gen():
    """theta -> grid at a 5x5 control lattice: atol 5e-5 (f32 sums of 28
    basis terms up to ~17 in magnitude, taken in another order)."""
    theta = (0.1 * np.random.RandomState(2).randn(3, 50)).astype(np.float32)
    ref = jops.TpsGridGen(32, 24, 5)(jnp.asarray(theta))
    out = tops.TpsGridGen(32, 24, 5)(torch.from_numpy(theta))
    assert out.shape == (3, 32, 24, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=5e-5)


def test_global_correlation_and_l2_norm():
    """Channel order k = x_A * H + y_A and the sqrt(sum + eps) norm:
    rtol 1e-5."""
    rng = np.random.RandomState(3)
    a = rng.randn(2, 4, 3, 16).astype(np.float32)
    b = rng.randn(2, 4, 3, 16).astype(np.float32)
    ja, jb = jops.feature_l2_norm(jnp.asarray(a)), jops.feature_l2_norm(jnp.asarray(b))
    ta, tb = tops.feature_l2_norm(torch.from_numpy(a)), tops.feature_l2_norm(torch.from_numpy(b))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    ref = jops.global_correlation(ja, jb)
    out = tops.global_correlation(ta, tb)
    assert out.shape == (2, 4, 3, 12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_preprocess_batch():
    """A uint8 raw batch laid out as __graft_entry__._raw_batch: every
    feature equal within 1e-6 (the silhouette's uint8 rounding included)."""
    opt = _sams_opt(fine_height=64, fine_width=48, n_frames_total=2,
                    person_inputs=["agnostic", "densepose", "flow"])
    raw = _raw_batch(opt, batch=2, rng_seed=5)
    ref = j_preprocess({k: jnp.asarray(v) for k, v in raw.items()}, JConfig.from_opt(opt))
    out = t_preprocess({k: torch.from_numpy(v) for k, v in raw.items()}, TConfig.from_opt(opt))
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].dtype == torch.float32, key
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=1e-6, err_msg=key)
