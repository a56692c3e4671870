"""Card-only tests of the measurement tools (shineon_tpu_torch/tools) and the
bench's inference half (shineon_tpu_torch/bench.py). They
import neither JAX nor the JAX package:

    python -m pytest tests/test_torch_measure_cuda.py -m gpu -q

Without a CUDA device they skip."""

import pytest
import torch

from shineon_tpu_torch.tracing import PLAN_COUNTERS
from test_torch_cuda import INT8_CONVS_PER_FRAME, SITES_PER_FRAME, SMALL, _cuda_or_skip


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_stage_launches_a_call(int8):
    """At test_torch_cuda.py's small depth, each stage's launches a call:
    none in features and gmm_warp, one frame's chain sites (and, int8,
    gated convs) in gen_frame, the clip's in gen_scan and one_clip."""
    _cuda_or_skip()
    from shineon_tpu_torch.serving import build_inference
    from shineon_tpu_torch.tools import serving_stages

    _, warp, sams, raw, n_frames = build_inference(2, int8_spade=int8, **SMALL)
    stages = serving_stages.build_stages(warp, sams, raw)
    chain = "fused_multispade_int8" if int8 else "fused_multispade"
    for name, stage in stages.items():
        got = serving_stages.stage_launches(stage, raw["flow_raw"].device)
        plans = {k: got.pop(k) for k in PLAN_COUNTERS}
        frames = {"features": 0, "gmm_warp": 0, "gen_frame": 1}.get(name, n_frames)
        want = {k: 0 for k in got}
        want[chain] = frames * SITES_PER_FRAME
        if int8:
            want["multispade_hidden_absmax"] = frames * SITES_PER_FRAME
            want["int8_conv3x3"] = want["int8_quantize"] = frames * INT8_CONVS_PER_FRAME
        assert got == want, name
        # every site launches from a plan, made once (its first call) or kept
        assert plans["plan_builds"] + plans["plan_hits"] == want[chain], name
        assert plans["segmap_builds"] + plans["segmap_hits"] == want[chain], name


@pytest.mark.gpu
def test_roof_census_int8_call_agrees_with_cudnn():
    """A roof-census shape's int8 call (ops.int8_conv.conv3x3_int8, cached
    slice images) against cuDNN's f32 conv of the same operands quantized
    and dequantized, within INT8_CONV_TOLERANCE in bf16; and the timer's
    device times of both formulations, kernel 4 inside the int8 call."""
    _cuda_or_skip()
    import torch.nn.functional as F

    from shineon_tpu_torch.ops.int8_conv import (
        INT8_CONV_TOLERANCE,
        activation_scale,
        quantize_levels,
    )
    from shineon_tpu_torch.tools import serving_roof_census as roof

    kh, kw, cin, cout, B, H, W, _, _ = roof.parse_shape("conv 3x3x64x128 -> 2x64x48x128 [i8]")
    x, weight, bias = roof.shape_operands(kh, kw, cin, cout, B, H, W, "cuda")
    with torch.no_grad():
        out = roof.shape_calls(x, weight, bias)["i8"](x).float()
    levels = quantize_levels(weight)
    w_deq = (levels.wq.float().reshape(3, 3, cout, cin).permute(2, 3, 0, 1)
             * levels.scale[:, None, None, None])
    s = activation_scale(x)
    x_deq = torch.clamp(torch.round(x.float() / s), -127, 127) * s
    ref = F.conv2d(x_deq.permute(0, 3, 1, 2), w_deq, padding=1).permute(0, 2, 3, 1)
    tol = INT8_CONV_TOLERANCE[torch.bfloat16]
    assert ((out - ref).abs() <= tol * (ref.abs() + ref.pow(2).mean().sqrt())).all()
    t = roof.card_timer("cuda", iters=1, repeats=1)(kh, kw, cin, cout, B, H, W)
    assert 0 < t["i8_conv_ms"] < t["i8_ms"] and t["bf16_ms"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_bench_inference_launches_a_clip(int8):
    """The bench's inference half at test_torch_cuda.py's small depth: each
    serving kernel's launches in one clip, a finite positive frames/s
    within its min and max, and the device's busy time and idle share."""
    _cuda_or_skip()
    from shineon_tpu_torch import bench

    r = bench.measure_inference(2, int8=int8, iters=2, repeats=1, **SMALL)
    n_frames = r["n_frames"]
    launched = dict(r["infer_clip_launches"])
    plans = {k: launched.pop(k) for k in PLAN_COUNTERS}
    want = {k: 0 for k in launched}
    if int8:
        want["fused_multispade_int8"] = want["multispade_hidden_absmax"] = (
            n_frames * SITES_PER_FRAME)
        want["int8_conv3x3"] = want["int8_quantize"] = n_frames * INT8_CONVS_PER_FRAME
    else:
        want["fused_multispade"] = n_frames * SITES_PER_FRAME
    assert launched == want
    assert plans["plan_builds"] + plans["plan_hits"] == n_frames * SITES_PER_FRAME
    assert r["mode"] == ("int8" if int8 else "bf16")
    assert 0 < r["infer_fps_min"] <= r["infer_fps"] <= r["infer_fps_max"] < float("inf")
    assert r["infer_busy_ms"] > 0 and r["infer_idle"] < 1
