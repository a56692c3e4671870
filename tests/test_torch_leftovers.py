"""The JAX package's last small functions and data tools on the port,
against the JAX package on the CPU: ``affine_grid`` (also against
``F.affine_grid``, whose semantics it has), ``denormalize_to_uint8``, and
shineon_tpu_torch.tools.convert_viton_raw against tools/convert_viton_raw.py
(the same files, byte for byte)."""

import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from shineon_tpu.ops.grid_sample import affine_grid as jax_affine_grid
from shineon_tpu.ops.image_ops import denormalize_to_uint8 as jax_denormalize
from shineon_tpu_torch.ops import affine_grid
from shineon_tpu_torch.ops.image_ops import denormalize_to_uint8
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def test_affine_grid_matches_jax_and_torch(rng):
    theta = rng.randn(3, 2, 3).astype(np.float32)
    for h, w in ((8, 6), (5, 7), (1, 1)):
        out = affine_grid(torch.from_numpy(theta), h, w).numpy()
        np.testing.assert_allclose(out, np.asarray(jax_affine_grid(jnp.asarray(theta), h, w)),
                                   rtol=1e-6, atol=1e-6)
        ref = F.affine_grid(torch.from_numpy(theta), (3, 1, h, w), align_corners=False)
        np.testing.assert_allclose(out, ref.numpy(), rtol=1e-5, atol=1e-6)


def test_denormalize_to_uint8_matches_jax(rng):
    # values on and beside the rounding midpoints, and past both ends
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4000), (np.arange(256) + 0.5) / 127.5 - 1.0,
                        np.arange(256) / 127.5 - 1.0]).astype(np.float32)
    out = denormalize_to_uint8(torch.from_numpy(x)).numpy()
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, np.asarray(jax_denormalize(jnp.asarray(x))))


def _raw_viton(root: Path, rng):
    for sub in ("cloth", "cloth-mask", "image", "image-parse", "pose"):
        (root / sub).mkdir(parents=True)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (64, 48, 3)).astype(np.uint8)).save(
            root / "image" / f"{i}_0.jpg")
        Image.fromarray(rng.randint(0, 255, (64, 48, 3)).astype(np.uint8)).save(
            root / "cloth" / f"{i}_1.jpg")
        Image.fromarray((rng.rand(64, 48) > 0.5).astype(np.uint8) * 255).save(
            root / "cloth-mask" / f"{i}_1.jpg")
        Image.fromarray(rng.randint(0, 20, (64, 48)).astype(np.uint8)).save(
            root / "image-parse" / f"{i}_0.png")
        kp = (rng.rand(18 * 3) * 40).tolist()
        (root / "pose" / f"{i}_0_keypoints.json").write_text(
            json.dumps({"people": [{"pose_keypoints": kp}]}))


def test_convert_viton_raw_matches_jax_tool(tmp_path, rng):
    _raw_viton(tmp_path / "raw", rng)
    args = ["--src", str(tmp_path / "raw"), "--height", "32", "--width", "20", "--dst"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    outs = []
    for cmd, dst in (([str(REPO / "tools" / "convert_viton_raw.py")], "jax"),
                     (["-m", "shineon_tpu_torch.tools.convert_viton_raw"], "port")):
        proc = subprocess.run([sys.executable, *cmd, *args, str(tmp_path / dst)],
                              capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs.append(proc.stdout.replace(str(tmp_path / dst), ""))
    assert outs[0] == outs[1] and "pose: 2 keypoint files" in outs[0]
    for sub in ("cloth", "cloth-mask", "image", "image-parse", "pose"):
        names = sorted(os.listdir(tmp_path / "jax" / sub))
        assert names == sorted(os.listdir(tmp_path / "port" / sub)) and len(names) == 2
        for name in names:
            assert filecmp.cmp(tmp_path / "jax" / sub / name, tmp_path / "port" / sub / name,
                               shallow=False), (sub, name)
    assert Image.open(tmp_path / "port" / "image" / "0_0.jpg").size == (20, 32)
