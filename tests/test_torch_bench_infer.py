"""The port bench's inference half (shineon_tpu_torch/bench.py) on the CPU,
held against the JAX bench (bench.py): the chained clips and their
arithmetic (bench.py:216-248, 258-264) with a recording stand-in clip and
an injected clock; the 1-clip window of the TINY serving clip against
serving.build_inference's clip; the JSON line against the line of the
root bench.main() built from the same numbers; no retry; no CUDA; the
--flops count; the --profile tables."""

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import jax  # noqa: F401 (JAX on the CPU before the JAX bench)
import pytest
import torch

from shineon_tpu_torch import bench, serving
from shineon_tpu_torch.tools import serving_stages
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)
from test_torch_serving import TINY
from test_torch_training import TINY_TRAIN

REPO = Path(__file__).resolve().parents[1]
TINY_CLIP = {k: v for k, v in TINY.items() if k != "batch_size"}
# the JAX line's fields that divide by A100 estimates, left out of the port's
BASELINE_KEYS = {"vs_baseline", "baseline_def", "vs_bar_5x", "train_vs_baseline",
                 "train_baseline_def"}
# what the port's line adds: the device, the card's line, each half's result
PORT_KEYS = {"device", "card", "inference", "training"}


class StandIn:
    """A serving clip stand-in: records each call's flow_raw and returns
    frames of mean MEAN x (its call number), large enough that mean x 1e-12
    moves the next call's flow; ``seconds(call)`` advances ``clock``."""

    MEAN = 2.0 ** 40

    def __init__(self, clock=None, seconds=None, fail=False):
        self.flows, self.clock, self.seconds, self.fail = [], clock, seconds, fail

    def __call__(self, raw):
        if self.fail:
            self.flows.append(None)
            raise RuntimeError("planted clip failure")
        self.flows.append(raw["flow_raw"].clone())
        if self.clock is not None:
            self.clock[0] += self.seconds(len(self.flows) - 1)
        return torch.full((2, 3, 4, 4, 3), self.MEAN * len(self.flows))


def stand_in_build(monkeypatch, clip):
    """bench.build_inference replaced by a build of ``clip`` (batch 2, 3
    frames, f32); returns the list of each build's arguments and the raw
    batch."""
    raw = {"flow_raw": torch.randn(2, 3, 4, 4, 2, generator=torch.Generator().manual_seed(0))}
    sams = SimpleNamespace(compute_dtype=torch.float32,
                           opt=SimpleNamespace(fine_height=4, fine_width=4))
    builds = []

    def build(batch, device, **options):
        builds.append((batch, device, options))
        return clip, None, sams, raw, 3

    monkeypatch.setattr(bench, "build_inference", build)
    return builds, raw


def test_each_clip_flow_is_the_original_plus_the_previous_mean(monkeypatch):
    """Each clip's flow_raw is the original plus the previous clip's frame
    mean x 1e-12 (in flow_raw's dtype, on the device); each window, the
    1-clip warm-up, then per repeat ITERS clips and 1 clip, starts from
    the original."""
    clip = StandIn()
    builds, raw = stand_in_build(monkeypatch, clip)
    r = bench.measure_inference(2, int8=False, device="cpu", iters=3, repeats=2)
    assert builds == [(2, "cpu", {"int8_spade": False})]
    assert len(clip.flows) == 1 + 2 * (3 + 1)
    starts = {0, 1, 4, 5, 8}  # the first clip of each window
    orig = raw["flow_raw"]
    for i, flow in enumerate(clip.flows):
        if i in starts:
            assert torch.equal(flow, orig), i
        else:
            acc = torch.tensor(StandIn.MEAN * i, dtype=torch.float32)
            assert torch.equal(flow, serving_stages.bumped(orig, acc)), i
            assert (flow - orig).abs().min() > 1.0, i
    assert r["infer_warmup_mean"] == StandIn.MEAN
    assert r["mode"] == "f32" and r["batch"] == 2 and r["iters"] == 3 and r["n_frames"] == 3
    assert not any(r["infer_clip_launches"].values())
    assert "infer_busy_ms" not in r


def test_clip_time_fps_and_mfu_from_an_injected_clock(monkeypatch):
    """With time.perf_counter patched to a clock that the stand-in clip
    advances: each repeat's clip time (total - one) / (ITERS - 1), floored
    at 1e-9 s; the median; fps = batch x frames / clip time with min and
    max; MFU = frames x analytic_generator_flops(batch) / clip time / 989
    TFLOP/s, rounded to 4 places as the JAX bench rounds it."""
    clock = [0.0]
    # (seconds a clip of the ITERS window, seconds of the 1-clip window) a repeat
    repeats = [(0.05, 0.05), (0.08, 0.02), (0.01, 0.5)]

    def seconds(call):
        if call == 0:
            return 7.0  # the warm-up window, not timed
        r, k = divmod(call - 1, bench.ITERS + 1)
        return repeats[r][k == bench.ITERS]

    stand_in_build(monkeypatch, StandIn(clock, seconds))
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    r = bench.measure_inference(2, device="cpu", repeats=3)
    want = [max((bench.ITERS * c - one) / (bench.ITERS - 1), 1e-9) for c, one in repeats]
    assert want[2] == 1e-9
    assert r["infer_clip_s_all"] == pytest.approx(want, rel=1e-9)
    assert r["infer_clip_s"] == pytest.approx(sorted(want)[1], rel=1e-9)
    frames = 2 * 3
    assert r["infer_fps"] == pytest.approx(frames / r["infer_clip_s"])
    assert r["infer_fps_min"] == pytest.approx(frames / max(want))
    assert r["infer_fps_max"] == pytest.approx(frames / 1e-9)
    assert r["infer_repeats"] == 3 and r["iters"] == bench.ITERS
    flops = 3 * bench.analytic_generator_flops(2)
    assert r["infer_clip_flops"] == flops
    assert r["infer_mfu"] == round(flops / r["infer_clip_s"] / 989e12, 4) > 0
    assert r["mode"] == "int8"


def test_one_clip_window_is_the_serving_clip(monkeypatch):
    """At TINY the bench's 1-clip warm-up window gives the frame mean of
    the clip serving.build_inference built, bit for bit: the bench times
    the serving clip, not a copy."""
    built = []

    def build(*args, **kwargs):
        built.append(serving.build_inference(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(bench, "build_inference", build)
    r = bench.measure_inference(2, int8=False, device="cpu", iters=2, repeats=1, **TINY_CLIP)
    one_clip, _, sams, raw, n_frames = built[0]
    assert len(built) == 1 and sams.opt.fine_height == 128 and not sams.opt.int8_spade
    with torch.no_grad():
        ref = float(one_clip(raw).float().mean())
    assert r["infer_warmup_mean"] == ref
    assert r["n_frames"] == n_frames == 3 and r["mode"] == "f32"
    assert r["infer_fps"] > 0 and len(r["infer_clip_s_all"]) == 1


def port_results():
    """measure_inference's and measure_train's results with fixed numbers."""
    infer = {"infer_fps": 291.2345678, "infer_clip_s": 80 / 291.2345678, "infer_mfu": 0.2191,
             "infer_fps_min": 288.8765432, "infer_fps_max": 293.1111111, "infer_repeats": 3,
             "infer_clip_flops": 5 * bench.analytic_generator_flops(16),
             "infer_clip_s_all": [0.27, 0.28, 0.275], "mode": "int8", "batch": 16}
    train = {"train_frames_per_sec_per_chip": 7.7987654, "train_step_ms": 2564.987654,
             "train_mfu": 0.0123456789, "train_step_flops": 123.0,
             "train_fast_gan_frames_per_sec_per_chip": 9.5432198}
    return infer, train


def jax_line(monkeypatch, capsys, argv, infer, train):
    """The root bench.main()'s JSON line, run in this process (--inner: no
    retry wrapper) with its measure_inference and measure_train patched to
    return the port's numbers in the JAX results' units and rounding."""
    import bench as jbench

    # main() sets SHINEON_INT8_SPADE with setdefault; set here first, monkeypatch
    # records it and removes it at teardown, so no later test sees int8 serving
    monkeypatch.setenv("SHINEON_INT8_SPADE", "1")
    monkeypatch.setattr(jbench, "measure_inference", lambda profile_dir=None: {
        **{k: v for k, v in infer.items() if k in (
            "infer_fps", "infer_clip_s", "infer_mfu", "infer_fps_min", "infer_fps_max",
            "infer_repeats", "infer_clip_flops")},
        "infer_clip_flops_cost_analysis": None})
    monkeypatch.setattr(jbench, "measure_train", lambda profile_dir=None: {
        "train_fps": train["train_frames_per_sec_per_chip"],
        "train_step_s": train["train_step_ms"] / 1e3,
        "train_mfu": round(train["train_mfu"], 4),
        "train_step_flops": train["train_step_flops"], "train_step_flops_cost_analysis": None,
        "train_fast_gan_fps": train["train_fast_gan_frames_per_sec_per_chip"]})
    monkeypatch.setattr(sys, "argv", ["bench.py", "--inner", *argv])
    capsys.readouterr()
    jbench.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("skip_train", [True, False], ids=["skip_train", "with_train"])
def test_json_line_has_the_jax_bench_fields(monkeypatch, capsys, skip_train):
    """The port's line from fixed results has the JAX line's keys less its
    five A100 baseline keys, with the same values, plus the device, the
    card's line and each half's whole result."""
    infer, train = port_results()
    ref = jax_line(monkeypatch, capsys, ["--skip_train"] if skip_train else [], infer, train)
    line = bench.result_line(infer, None if skip_train else train, "NVIDIA H100 80GB HBM3",
                             "NVIDIA H100 80GB HBM3, 700.00 W")
    assert set(line) - PORT_KEYS == set(ref) - BASELINE_KEYS
    assert BASELINE_KEYS & set(ref) == (
        BASELINE_KEYS if not skip_train else {"vs_baseline", "baseline_def", "vs_bar_5x"})
    for key in set(ref) - BASELINE_KEYS:
        assert line[key] == ref[key], key
    assert ("train_step_ms" in line) != skip_train
    assert line["inference"] is infer and line["training"] == (None if skip_train else train)
    assert line["card"].endswith("700.00 W")


def test_a_failed_clip_fails_the_run_once(monkeypatch):
    """No retry: a clip that raises fails main() after one build and one
    clip call."""
    clip = StandIn(fail=True)
    builds, _ = stand_in_build(monkeypatch, clip)
    with pytest.raises(RuntimeError, match="planted clip failure"):
        bench.main(["--device", "cpu", "--skip_train", "--batch", "2"])
    assert len(builds) == 1 and len(clip.flows) == 1


def test_bench_exits_without_cuda():
    """Run as its users run it, the bench exits 1 and prints no result on a
    host without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run([sys.executable, "-m", "shineon_tpu_torch.bench", "--skip_train"],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 1, proc.stderr
    assert "no CUDA device" in proc.stderr
    assert proc.stdout == ""


def test_flops_counts_one_clip_at_batch_1(capsys):
    """--flops: the census of a generator forward times the frames, plus
    the GMM's convs, within 10% of frames x analytic_generator_flops(1);
    no bytes count."""
    assert bench.main(["--flops"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    analytic = 5 * bench.analytic_generator_flops(1)
    assert out["analytic_clip_flops_b1"] == analytic
    assert abs(out["gen_clip_flops_b1"] / analytic - 1) < 0.10
    assert out["gen_clip_flops_b1"] == 5 * out["generator_flops_b1"] + out["gmm_conv_flops_b1"]
    assert out["gmm_conv_flops_b1"] > 0 and out["gen_clip_bytes_b1"] is None
    assert out["mode"] == "int8"


def test_profile_is_refused_on_the_cpu(tmp_path):
    """--profile tables device ops: with --device cpu there are none, and
    the bench refuses before it builds anything."""
    with pytest.raises(SystemExit) as exit_:
        bench.main(["--device", "cpu", "--skip_train", "--profile",
                    "--profile_out", str(tmp_path)])
    assert exit_.value.code == 2
    assert not any(tmp_path.iterdir())


def docs_profiles():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / "docs").glob("PROFILE*.md"))}


def test_profile_writes_both_tables(monkeypatch, tmp_path):
    """With injected marked traces (20 device ops), --profile's functions
    write the JAX bench's two tables into the directory given, the top 15
    ops by device ms a clip or step with their launches and shares, under a
    header that names the card, the batch, the mode and the clip or step
    time; the training table traces the TINY step itself. docs/ is left
    alone."""
    docs = docs_profiles()
    table = {f"kernel_{i}": (1.0 * (i + 1), 2) for i in range(20)}
    traced = []

    def fake_busy(stage, device):
        traced.append(float(serving_stages.chained(stage, 1, device)))
        return 210.0, 250.0, table

    def fake_device_times(fn, groups, reps, extra, ops):
        fn()
        traced.append(reps)
        return {"busy": 210.0, "wall": 3000.0, "ops": table}

    monkeypatch.setattr(serving_stages, "busy_ms", fake_busy)
    monkeypatch.setattr(bench, "device_times", fake_device_times)
    monkeypatch.setattr(bench, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    stand_in_build(monkeypatch, StandIn())
    r = bench.measure_inference(2, device="cpu", iters=2, repeats=1, profile_dir=tmp_path)
    assert r["infer_busy_ms"] == 210.0 and r["infer_traced_ms"] == 250.0
    real_build = bench.build_train
    monkeypatch.setattr(bench, "build_train",
                        lambda batch, **kw: real_build(1, device="cpu", **{**TINY_TRAIN, **kw}))
    t = bench.profile_train(tmp_path, 2564.9)
    assert t["busy"] == 210.0 and len(traced) == 2 and traced[1] == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["PROFILE.md", "PROFILE_INFER.md"]
    total = sum(ms for ms, _ in table.values())
    for name, call, words in (
            ("PROFILE_INFER.md", "clip", ("batch 2", "int8", f"{r['infer_clip_s'] * 1e3:.1f} ms")),
            ("PROFILE.md", "step", (f"batch {bench.TRAIN_BATCH}", "exact", "2565 ms"))):
        text = (tmp_path / name).read_text()
        assert "NVIDIA H100 80GB HBM3, 700.00 W" in text
        assert all(w in text for w in words), name
        assert f"| op | ms a {call} | launches a {call} | % of device time |" in text
        rows = [line for line in text.splitlines() if line.startswith("| `")]
        assert len(rows) == bench.PROFILE_TOP
        assert rows[0] == f"| `kernel_19` | 20.00 | 2 | {100 * 20 / total:.1f}% |"
        assert rows[-1].startswith("| `kernel_5` | 6.00 | 2 |")
    assert docs_profiles() == docs


def test_trace_prints_the_step_table(monkeypatch, capsys):
    """--trace prints profile_train's table of one marked exact step, with
    its traced wall time, busy time and idle share, and writes nothing."""
    table = {"chain": (3.0, 150), "conv": (1.0, 110)}
    monkeypatch.setattr(bench, "device_times", lambda fn, groups, reps, extra, ops: {
        "busy": 4.0, "wall": 10.0, "ops": table})
    monkeypatch.setattr(bench, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    warmed = (None, None, None, 3)
    t = bench.profile_train(None, attention=True, steps=1, warmed=warmed)
    out = capsys.readouterr().out
    assert t["ops"] == table
    assert "traced 10 ms, device busy 4 ms, idle share 0.600" in out and "attention" in out
    assert "| `chain` | 3.00 | 150 | 75.0% |" in out and "| `conv` | 1.00 | 110 | 25.0% |" in out
