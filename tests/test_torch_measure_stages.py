"""The serving clip's stage functions (shineon_tpu_torch/serving.py) and
the stage timing tool (shineon_tpu_torch/tools/serving_stages.py) on the
CPU, at test_torch_serving.py's TINY options: the stages composed equal
one_clip bit for bit; features, gmm_warp and gen_scan each against their
part of the JAX clip (bench.py::build_inference's body, with the same
weights carried across by shineon_tpu_torch.convert); the chained loop's
inputs depend on the previous call's output; the tool's command line
refuses a host without CUDA unless told to run on the CPU."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _raw_batch, _sams_opt
from shineon_tpu.models.sams_model import SamsModel as JSamsModel
from shineon_tpu.models.warp_model import WarpModel as JWarpModel
from shineon_tpu.ops import grid_sample as j_grid_sample
from shineon_tpu_torch import convert
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.models.warp_model import WarpModel
from shineon_tpu_torch.options import sams_options, warp_options
from shineon_tpu_torch.serving import (
    frame_inputs,
    gen_frame,
    gen_scan,
    gmm_warp,
    make_one_clip,
    with_warped_cloth,
)
from shineon_tpu_torch.tools import serving_stages
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)
from test_torch_serving import TINY, _max_rel, _np

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def clip():
    """The TINY JAX and port models with the same weights, and one raw
    batch on each side."""
    jsams = JSamsModel(_sams_opt(is_train=False, **TINY))
    jwarp = JWarpModel(_sams_opt(is_train=False, model="warp", flow_warp=False, grid_size=5,
                                 person_inputs=["agnostic", "densepose"], **TINY))
    g = jsams.init_state(jax.random.PRNGKey(420), 1).nets["generator"]
    w = jwarp.init_state(jax.random.PRNGKey(7), 1).nets["gmm"]
    sams = SamsModel(sams_options(**TINY), device="cpu")
    warp = WarpModel(warp_options(**TINY), device="cpu")
    convert.load_flax(sams.generator, _np({"params": g.params, **g.stats}),
                      convert.GENERATOR_RENAMES)
    warp_vars = {"params": w.params, **w.stats}
    convert.load_flax(warp.gmm, _np(warp_vars), convert.GMM_RENAMES)
    raw = _raw_batch(_sams_opt(**TINY), batch=2)
    return dict(jsams=jsams, jwarp=jwarp, g=g, warp_vars=warp_vars, sams=sams, warp=warp,
                jbatch={k: jnp.asarray(v) for k, v in raw.items()},
                tbatch={k: torch.from_numpy(v) for k, v in raw.items()})


def test_stages_composed_equal_one_clip(clip):
    """The stage functions one after another are one_clip, bit for bit,
    and so are the tool's timed stages composed."""
    sams, warp, raw = clip["sams"], clip["warp"], clip["tbatch"]
    with torch.no_grad():
        feats = sams.features(raw)
        composed = gen_scan(sams, with_warped_cloth(feats, gmm_warp(warp, feats)))
    ref = make_one_clip(warp, sams)(raw)
    assert ref.shape == (2, 3, 128, 96, 3) and torch.isfinite(ref).all()
    assert torch.equal(composed, ref)
    stages = serving_stages.build_stages(warp, sams, raw)
    assert torch.equal(serving_stages.compose_stages(stages), ref)


def test_features_match_jax(clip):
    """The features stage against the JAX clip's (max rel 1e-5 a key)."""
    ref = jax.jit(clip["jsams"].features)(clip["jbatch"])
    with torch.no_grad():
        out = clip["sams"].features(clip["tbatch"])
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert _max_rel(out[k].numpy(), np.asarray(ref[k])) <= 1e-5, k


def test_gmm_warp_matches_jax(clip):
    """The GMM's grid and the border warp of the last cloth against the JAX
    clip's (max rel 1e-3, test_torch_serving.py's clip limit)."""
    jwarp = clip["jwarp"]

    @jax.jit
    def ref_warp(warp_vars, feats):
        person = jnp.concatenate([feats["agnostic"][:, -1], feats["densepose"][:, -1]], -1)
        cloth_in = feats["cloth"][:, -1]
        grid, _ = jwarp.gmm.apply(warp_vars, person, cloth_in, train=False)
        return j_grid_sample(cloth_in, grid, padding_mode="border")

    ref = ref_warp(clip["warp_vars"], jax.jit(clip["jsams"].features)(clip["jbatch"]))
    with torch.no_grad():
        out = gmm_warp(clip["warp"], clip["sams"].features(clip["tbatch"]))
    assert out.shape == (2, 128, 96, 3)
    assert _max_rel(out.numpy(), ref) <= 1e-3


def test_gen_scan_matches_jax(clip, monkeypatch):
    """The eval clip loop on the same features against the JAX
    generate_n_frames(train=False) (max rel 1e-3; the JAX side takes the
    fused chain's CPU reference formulation, SHINEON_FUSED_SPADE=1)."""
    monkeypatch.setenv("SHINEON_FUSED_SPADE", "1")
    jsams, g = clip["jsams"], clip["g"]
    feats = jax.jit(jsams.features)(clip["jbatch"])
    ref = jax.jit(lambda p, s, f: jsams.generate_n_frames(p, s, f, train=False)[2])(
        g.params, g.stats, feats)
    with torch.no_grad():
        out = gen_scan(clip["sams"], clip["sams"].features(clip["tbatch"]))
    assert torch.isfinite(out).all()
    assert _max_rel(out.numpy(), ref) <= 1e-3


def recorded_loop(sams, feats, monkeypatch):
    """The eval clip loop with each generator call's (window, prev_maps,
    current_maps, output) recorded."""
    calls, frame = [], sams.frame

    def recording(window, prev_maps, current_maps, train):
        out = frame(window, prev_maps, current_maps, train)
        calls.append((window, prev_maps, current_maps, out))
        return out

    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(sams, "frame", recording)
        gen_scan(sams, feats)
    return calls


@pytest.mark.parametrize("frames_now", [3, 1])
def test_gen_frame_is_the_loop_body(clip, monkeypatch, frames_now):
    """gen_frame is the clip loop's generator call, and frame_inputs are
    the inputs the loop gives its last frame: the same maps bit for bit
    and a window of the same shape and dtype, zero where the loop has
    generated no frame yet. With one frame now (the loop runs the last
    frame alone, on a zero window) gen_frame at frame_inputs is that call's
    output bit for bit."""
    sams = clip["sams"]
    monkeypatch.setattr(sams, "n_frames_now", frames_now)
    with torch.no_grad():
        feats = sams.features(clip["tbatch"])
        window, prev_maps, current_maps = frame_inputs(sams, feats)
    calls = recorded_loop(sams, feats, monkeypatch)
    assert len(calls) == frames_now
    loop_window, loop_prev, loop_current, loop_out = calls[-1]
    assert window.shape == loop_window.shape == (2, 2, 128, 96, 3)
    assert window.dtype == loop_window.dtype and not window.any()
    assert torch.equal(prev_maps, loop_prev)
    assert torch.equal(prev_maps, feats[sams.opt.encoder_input][:, :2])
    assert sorted(current_maps) == sorted(loop_current) == sorted(sams.inputs)
    for k in current_maps:
        assert torch.equal(current_maps[k], loop_current[k]), k
    with torch.no_grad():
        assert torch.equal(gen_frame(sams, loop_window, loop_prev, loop_current), loop_out)
        out = gen_frame(sams, window, prev_maps, current_maps)
    assert out.shape == (2, 128, 96, 4)  # the frame and the flow-warp mask
    assert torch.equal(out, loop_out) == (frames_now == 1)


def test_chained_loop_feeds_each_output_to_the_next_input():
    """Each call's input is the first input moved by the previous call's
    mean (acc * 1e-12), the first call's by 0."""
    seen, outs = [], []

    def call(x):
        outs.append(x * 3 + len(outs))
        return {"a": outs[-1], "b": outs[-1][:1]}

    def perturb(x, acc):
        seen.append(float(acc))
        return serving_stages.bumped(x, acc)

    x0 = torch.arange(4, dtype=torch.float64)
    last = serving_stages.chained((call, x0, perturb), 3, "cpu")
    assert seen[0] == 0.0 and len(seen) == 3
    for i in (1, 2):
        prev = {"a": outs[i - 1], "b": outs[i - 1][:1]}
        assert seen[i] == float(serving_stages.tree_mean(prev))
    assert float(last) == float(serving_stages.tree_mean({"a": outs[2], "b": outs[2][:1]}))
    acc = torch.tensor(1e12, dtype=torch.float64)
    assert torch.equal(serving_stages.bumped(x0, acc), x0 + 1)


def test_every_stage_input_moves_with_the_previous_output(clip):
    """In each stage of the TINY clip the perturbation reaches the input
    the stage reads: an accumulator of 1e12 moves it by 1 (f32 leaves)."""
    sams, warp, raw = clip["sams"], clip["warp"], clip["tbatch"]
    stages = serving_stages.build_stages(warp, sams, raw)
    assert tuple(stages) == serving_stages.STAGES
    leaf = {"features": "flow_raw", "gmm_warp": "cloth", "gen_scan": "flow",
            "one_clip": "flow_raw"}
    acc = torch.tensor(1e12)
    for name, (_, x0, perturb) in stages.items():
        moved = perturb(x0, acc)
        if name == "gen_frame":
            before, after = x0, moved
        else:
            before, after = x0[leaf[name]], moved[leaf[name]]
            if name == "gmm_warp":
                before = before[:, -1:]
        assert torch.allclose(after.double() - before.double(), torch.ones(()).double()), name


class _Event:
    """A profiler event's name and duration, as tools.call_means reads them."""

    def __init__(self, name, us):
        self.name = name
        self.time_range = type("Range", (), {"elapsed_us": lambda _self: us})()


def test_call_means_sums_each_group_a_call_and_refuses_short_traces():
    """tools.call_means (the device-time protocol of the tools and of
    chip_smoke.py): each group's summed duration a call, the mean over the
    calls; None where the trace holds fewer calls than asked, or a group's
    kernel count differs between calls or is 0."""
    from shineon_tpu_torch.tools import call_means

    calls = [[_Event("chain_kernel_bf16", 100), _Event("fprop_conv", 30),
              _Event("fprop_conv", 10)],
             [_Event("chain_kernel_bf16", 300), _Event("fprop_conv", 50),
              _Event("fprop_conv", 10)]]
    groups = {"all": None, "chain": ("chain_kernel",), "cudnn": ("fprop",)}
    assert call_means(calls, 2, groups) == {"all": 0.25, "chain": 0.2, "cudnn": 0.05}
    assert call_means(calls, 3, groups) is None
    assert call_means([calls[0], calls[1][:2]], 2, groups) is None
    assert call_means(calls, 2, {"attention": ("attention_wgmma",)}) is None


def test_op_means_gives_each_kernel_a_call():
    """tools.op_means (the --profile tables' reading of the same marked
    calls): each kernel name's device ms and launches a call, the means
    over the calls, a kernel absent from a call counted 0 there."""
    from shineon_tpu_torch.tools import op_means

    calls = [[_Event("chain_kernel_bf16", 100), _Event("fprop_conv", 30),
              _Event("fprop_conv", 10)],
             [_Event("chain_kernel_bf16", 300), _Event("fprop_conv", 50)]]
    ops = op_means(calls)
    assert set(ops) == {"chain_kernel_bf16", "fprop_conv"}
    assert ops["chain_kernel_bf16"] == pytest.approx((0.2, 1))
    assert ops["fprop_conv"] == pytest.approx((0.045, 1.5))


def test_measure_stages_on_cpu_reports_the_jax_fields(clip):
    """measure_stages on explicit CPU tensors with a cheap stand-in for
    every stage: the JAX tool's fields, derived as there, every launch
    count 0, no device fields."""
    x0 = torch.ones(3)
    stages = {name: ((lambda x, k=i: x * (k + 1)), x0, serving_stages.bumped)
              for i, name in enumerate(serving_stages.STAGES)}
    t = serving_stages.measure_stages(stages, n_frames=5, batch=4, device="cpu", iters=1,
                                      repeats=1)
    for name in serving_stages.STAGES:
        assert t[f"{name}_ms"] > 0 and not any(t[f"{name}_launches"].values())
        assert f"{name}_busy_ms" not in t
    assert t["scan_minus_5xframe_ms"] == pytest.approx(t["gen_scan_ms"] - 5 * t["gen_frame_ms"])
    assert t["clip_minus_stages_ms"] == pytest.approx(
        t["one_clip_ms"] - t["features_ms"] - t["gmm_warp_ms"] - t["gen_scan_ms"])
    assert t["clip_fps"] == pytest.approx(4 * 5 / (t["one_clip_ms"] / 1e3))


@pytest.mark.parametrize("tool", ["serving_stages", "serving_roof_census", "train_ablate",
                                  "input_pipeline"])
def test_timing_tools_exit_without_cuda(tool, tmp_path):
    """Each timing tool, run as its users run it, exits 1 and measures
    nothing on a host without CUDA unless given --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    census = tmp_path / "census.json"
    census.write_text('{"batch": 1, "int8": false, "n_frames": 5, "convs": []}')
    args = ["--census", str(census)] if tool == "serving_roof_census" else []
    proc = subprocess.run([sys.executable, "-m", f"shineon_tpu_torch.tools.{tool}", *args],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 1, proc.stderr
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""
