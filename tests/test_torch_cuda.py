"""Card-only tests of the port's serving path. They import neither JAX nor
the JAX package, so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_fused_spade.py tests/test_torch_cuda.py -m gpu -q

Without a CUDA device they skip."""

import pytest
import torch

# 128x96, 3-frame clips, widths 2^6..2^7: one encoder block (3 SPADE
# sites), one middle block (2) and one decoder block (3), 8 sites a frame
SMALL = dict(fine_height=128, fine_width=96, n_frames_total=3, n_frames_now=3,
             ngf_pow_outer=6, ngf_pow_inner=7, num_middle=1, ngf=8, precision=16)
SITES_PER_FRAME = 8


@pytest.mark.gpu
def test_build_inference_cuda_launches_kernel_per_spade_site():
    """On the card a small bf16 clip launches the chain kernel once per
    SPADE site and gives finite frames of the clip's shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from shineon_tpu_torch.ops.fused_spade import fused_multispade_modulate
    from shineon_tpu_torch.serving import build_inference

    one_clip, warp, sams, raw, n_frames = build_inference(2, **SMALL)
    before = fused_multispade_modulate.launches
    frames = one_clip(raw)
    torch.cuda.synchronize()
    assert frames.shape == (2, n_frames, 128, 96, 3)
    assert torch.isfinite(frames.float()).all()
    assert fused_multispade_modulate.launches - before == n_frames * SITES_PER_FRAME
