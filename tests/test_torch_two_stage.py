"""The port's two-stage chain (shineon_tpu_torch/tools/two_stage_chain.py)
on the CPU, tiny: synthetic VVT trees of two 4-frame videos at 128x128
(the smallest size both stages take: TOM's six-level U-Net needs sides
divisible by 64, the GMM's regression tower at least 128x96), batch 2, f32;
the GMM at ngf 8, TOM at its documented options otherwise (three
attention levels, swish). Stage 1 fits the GMM for one step and exports
the test split's warp cloths; the export run again writes nothing; stage 2
fits TOM for one step reading those files through ``warp_cloth_dir`` (the
trees hold no other warp cloths) and its frames are scored."""

import glob
import os.path as osp

import pytest
import torch

from shineon_tpu_torch.tools.two_stage_chain import run_chain


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps them from
    fighting the suite's other workers for the cores (where a busy host's
    spinning threads cost these tests up to ten times their time)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_warp_export_feeds_tom(tmp_path):
    r = run_chain(fine_height=128, fine_width=128, frames_per_video=4, batch_size=2,
                  limit_train_batches="0.5", workdir=str(tmp_path), device="cpu",
                  gmm_overrides=dict(ngf=8, precision=32), tom_overrides=dict(precision=32))
    # the test split holds vid0 (val_fraction 0.1 of two videos): 4 frames,
    # one warped cloth each, and the second export skipped every file
    assert r["stage1_samples"] == r["stage1_warp_cloth_files"] == 4, r
    assert r["stage1_resume_skipped_all"], r
    assert not glob.glob(osp.join(str(tmp_path), "vvt", "*", "warp-cloth"))
    assert r["warp_cloth_dir"].endswith(osp.join("test", "VVTDataset", "warp-cloth"))
    assert r["tom_train_steps"] == 1 and r["tom_test_batches"] == 2
    assert r["frames_scored"] == 4
    assert 0.0 <= r["ssim_tryon"] <= 1.0 and r["psnr_tryon"] > 0
