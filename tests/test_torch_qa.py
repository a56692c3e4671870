"""The port's QA loop and scoring command lines against the JAX package on
the CPU: shineon_tpu_torch.calculate_metrics, .plot_all_videos and
.convert_folders_to_animated against the repository's root scripts (the
same summary lines, and CSVs, plots and GIFs byte for byte); the
reconstruction export of tiny TOM and SAMS states carried from the JAX
package's init_state(PRNGKey(420)) (convert.load_jax_train_state) by both
packages' Trainer.test, fp and SAMS int8; and
shineon_tpu_torch.tools.e2e_quality.run_e2e's whole chain (synthetic
tree, export at init, Trainer.fit through train.run, trained and int8
exports, scoring in a subprocess). The improvement runs at the JAX tests'
configurations (tests/test_e2e_quality.py) are marked slow, as theirs are:
TOM's 300 steps took 422 s of one thread here."""

import filecmp
import math
import os
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
from flax import serialization, traverse_util
from PIL import Image

import shineon_tpu.native as jnative
from shineon_tpu_torch.convert import load_jax_train_state
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.models.unet_mask_model import UnetMaskModel
from shineon_tpu_torch.tools import e2e_quality as port_e2e
from shineon_tpu_torch.tools.quality_curve import TINY_SAMS
from test_metrics_cli import _make_video_folders
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
TINY_TOM = {"ngf": 8, "num_attn": 0, "self_attn": False}


def _run(args, cwd=REPO):
    out = subprocess.run([sys.executable, *args], capture_output=True, text=True, timeout=600,
                         cwd=cwd, env=ENV)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        assert filecmp.cmp(osp.join(a, name), osp.join(b, name), shallow=False), name


# ------------------------------------------------------ the command lines

def test_calculate_metrics_matches_jax_script(tmp_path):
    """The summary line (gen2 is the ground truth: SSIM 1, PSNR inf), the
    per-video CSV and the plot, byte for byte."""
    _make_video_folders(str(tmp_path))
    args = ["-t", str(tmp_path / "gt"), "-g1", str(tmp_path / "gen1"), "-g2",
            str(tmp_path / "gen2"), "--experiment_one", "a", "--experiment_two", "b",
            "--no_video", "--result"]
    ref = _run([osp.join(REPO, "calculate_metrics.py"), *args, str(tmp_path / "jax")])
    out = _run(["-m", "shineon_tpu_torch.calculate_metrics", *args, str(tmp_path / "port")])
    assert out == ref and "ssim_2=1.0000" in out and "psnr_2=inf" in out, (out, ref)
    _same_files(tmp_path / "jax", tmp_path / "port")
    assert sorted(os.listdir(tmp_path / "port")) == ["a_b_vid0_metrics_output.csv",
                                                     "a_b_vid0_plot.png"]


def test_plot_all_videos_matches_jax_script(tmp_path):
    _make_video_folders(str(tmp_path), n_frames=4, seed=3)
    args = ["-t", str(tmp_path / "gt"), "-g", str(tmp_path / "gen1"), "--experiment", "x",
            "--result"]
    ref = _run([osp.join(REPO, "plot_all_videos.py"), *args, str(tmp_path / "out")])
    out = _run(["-m", "shineon_tpu_torch.plot_all_videos", *args, str(tmp_path / "out2")])
    assert out.replace("out2", "out") == ref and "frames=4" in out
    assert filecmp.cmp(tmp_path / "out" / "x_all_videos_metrics.csv",
                       tmp_path / "out2" / "x_all_videos_metrics.csv", shallow=False)


def test_convert_folders_to_animated_matches_jax_script(tmp_path):
    _make_video_folders(str(tmp_path), n_frames=3)
    ref = _run([osp.join(REPO, "convert_folders_to_animated.py"), "-i", str(tmp_path / "gt"),
                "-o", str(tmp_path / "jax"), "--fps", "10"])
    out = _run(["-m", "shineon_tpu_torch.convert_folders_to_animated", "-i",
                str(tmp_path / "gt"), "-o", str(tmp_path / "port"), "--fps", "10"])
    assert out.replace("port", "jax") == ref
    _same_files(tmp_path / "jax", tmp_path / "port")


# ---------------------------------------------------- the export against JAX

def _jax_export(model_name, opt_kw, int8, result_dir, monkeypatch):
    """The JAX tool's export of the JAX model's init_state(PRNGKey(420));
    returns (its reconstruction folder, the state flattened as the README
    dumps a checkpoint)."""
    from shineon_tpu.models.sams_model import SamsModel as JSamsModel
    from shineon_tpu.models.unet_mask_model import UnetMaskModel as JUnetMaskModel
    from tools import e2e_quality as jax_e2e

    monkeypatch.setattr(jnative, "get_lib", lambda: None)  # PIL decode, as the port's
    cls = JSamsModel if model_name == "sams" else JUnetMaskModel
    jmodel = cls(jax_e2e._namespace(**opt_kw))
    state = jmodel.init_state(jax.random.PRNGKey(420), 3)
    flat = traverse_util.flatten_dict(serialization.to_state_dict(
        jax.device_get(state)), sep="/")
    if int8:
        monkeypatch.setenv("SHINEON_INT8_SPADE", "1")
    try:
        return jax_e2e._export(cls, opt_kw, state, result_dir), flat
    finally:
        monkeypatch.delenv("SHINEON_INT8_SPADE", raising=False)


def _exported(folder):
    """The export's frames, a folder a video, as relative paths."""
    return sorted(osp.relpath(osp.join(d, f), folder) for d, _, files in os.walk(folder)
                  for f in files)


def _frames(folder):
    names = _exported(folder)
    return names, np.stack([np.asarray(Image.open(osp.join(folder, n)).convert("RGB"),
                                       np.int16) for n in names])


@pytest.mark.parametrize("model_name,int8", [("unet_mask", False), ("sams", False),
                                             ("sams", True)])
def test_export_matches_jax_trainer_test(tmp_path, monkeypatch, model_name, int8):
    """A tiny state drawn by the JAX package and carried across with
    convert.load_jax_train_state; both packages' Trainer.test export the
    12 test frames of vid0 (the validation split takes vid1). The port's
    frames within 1 level of the JAX frames at 99.5% of the values and 8 at
    most (f32 rounding moves a value across a level; SAMS's untrained clip
    feeds each frame into the next), and their SSIM/PSNR against the
    ground truth within 2e-3 and 0.05 dB."""
    data = str(tmp_path / "vvt")
    from shineon_tpu_torch.tools.synthetic_data import make_vvt_tree

    # the U-Net's six levels need 64 pixels a side
    h, w = (64, 64) if model_name == "unet_mask" else (32, 24)
    for datamode in ("train", "test"):
        make_vvt_tree(data, n_videos=2, frames=12, datamode=datamode, seed=7, height=h, width=w)
    arch = port_e2e.UNET_MASK if model_name == "unet_mask" else {}
    extra = TINY_TOM if model_name == "unet_mask" else TINY_SAMS
    opt_kw = dict(model=model_name, vvt_dataroot=data, fine_height=h, fine_width=w,
                  n_frames_total=3, n_frames_now=3, batch_size=4, lr=1e-3, precision=32,
                  experiments_dir=str(tmp_path / "exp"), name="e2e")
    opt_kw.update({**arch, **extra})
    ref_dir, flat = _jax_export(model_name, opt_kw, int8, str(tmp_path / "jax"), monkeypatch)

    cls = SamsModel if model_name == "sams" else UnetMaskModel
    model = cls(port_e2e.namespace(True, **opt_kw, gpu_ids=[]), "cpu")
    state = load_jax_train_state(flat, model.make_state(3))
    out_dir = port_e2e.export({**opt_kw, "int8_spade": int8}, state, str(tmp_path / "port"),
                              "cpu")
    names, out = _frames(out_dir)
    ref_names, ref = _frames(ref_dir)
    assert names == ref_names and len(names) == 12
    diff = np.abs(out - ref)
    if not int8:
        assert diff.max() <= 8 and np.mean(diff <= 1) >= 0.995, (diff.max(), np.mean(diff <= 1))

    gt = str(tmp_path / "gt")
    port_e2e.crop_gt(osp.join(data, "test", "test_frames"), gt, w, h)
    frames, s_port, s_jax, p_port, p_jax = port_e2e.score(gt, out_dir, "port", ref_dir, "jax",
                                                          str(tmp_path / "m"))
    assert frames == 12
    ssim_tol, psnr_tol = (0.02, 1.0) if int8 else (2e-3, 0.05)
    assert abs(s_port - s_jax) <= ssim_tol and abs(p_port - p_jax) <= psnr_tol, (
        s_port, s_jax, p_port, p_jax)


# --------------------------------------------------------------- the loop

def _finite(r, *keys):
    return all(math.isfinite(r[k]) for k in keys)


def test_sams_chain_one_epoch_with_int8(tmp_path):
    """The whole chain at the tiny SAMS configuration for one epoch (3
    steps): the init, trained and int8 exports, 12 frames each, scored in
    a subprocess; the int8 export within the JAX test's envelope of the fp
    export of the same trained state."""
    r = port_e2e.run_e2e(
        model_name="sams", fine_height=32, fine_width=24, n_frames=3, frames_per_video=12,
        batch_size=4, epochs=1, lr=1e-3, workdir=str(tmp_path), device="cpu",
        arch_overrides={**TINY_SAMS, "decay_epochs": 0},
        extra_exports={"int8": {"int8_spade": True}})
    assert r["frames_scored"] == 12 and r["train_steps"] == 3, r
    assert _finite(r, "ssim_init", "ssim_trained", "ssim_int8", "psnr_trained", "psnr_int8"), r
    for name, folder in r["exports"].items():
        assert _exported(folder) == [f"vid0-g00/frame_{t:03d}.png" for t in range(12)], name
    assert abs(r["ssim_int8"] - r["ssim_trained"]) < 0.02, r
    assert abs(r["psnr_int8"] - r["psnr_trained"]) < 1.0, r
    assert sorted(r["seconds"]) == ["export_init", "export_int8", "export_trained", "fit",
                                    "score"]


def test_tom_chain_one_epoch(tmp_path):
    """TOM's chain at 64x64 for one epoch (3 steps at lr 3e-3): 12 frames
    scored, the trained export already closer to the ground truth."""
    r = port_e2e.run_e2e(
        model_name="unet_mask", fine_height=64, fine_width=64, n_frames=1, frames_per_video=12,
        batch_size=4, epochs=1, lr=3e-3, workdir=str(tmp_path), device="cpu",
        arch_overrides={**TINY_TOM, "decay_epochs": 0})
    assert r["frames_scored"] == 12 and r["train_steps"] == 3, r
    assert _finite(r, "ssim_init", "ssim_trained", "psnr_init", "psnr_trained"), r
    assert r["psnr_trained"] > r["psnr_init"], r


@pytest.mark.slow
def test_tom_train_improves_exported_metrics(tmp_path):
    """tests/test_e2e_quality.py's TOM case on the port (300 steps)."""
    r = port_e2e.run_e2e(
        model_name="unet_mask", fine_height=64, fine_width=64, n_frames=1, frames_per_video=12,
        batch_size=4, epochs=50, lr=3e-3, workdir=str(tmp_path), device="cpu",
        arch_overrides=TINY_TOM)
    assert r["frames_scored"] == 12
    assert r["ssim_trained"] > r["ssim_init"] + 0.1, r
    assert r["psnr_trained"] > r["psnr_init"] + 1.0, r


@pytest.mark.slow
def test_sams_train_improves_exported_metrics(tmp_path):
    """tests/test_e2e_quality.py's SAMS case on the port (210 steps), with
    its int8 envelope."""
    r = port_e2e.run_e2e(
        model_name="sams", fine_height=32, fine_width=24, n_frames=3, frames_per_video=12,
        batch_size=4, epochs=35, lr=1e-3, workdir=str(tmp_path), device="cpu",
        arch_overrides=dict(TINY_SAMS), extra_exports={"int8": {"int8_spade": True}})
    assert r["frames_scored"] == 12
    assert r["ssim_trained"] > r["ssim_init"] + 0.1, r
    assert r["psnr_trained"] > r["psnr_init"] + 1.0, r
    assert abs(r["ssim_int8"] - r["ssim_trained"]) < 0.02, r
    assert abs(r["psnr_int8"] - r["psnr_trained"]) < 1.0, r
