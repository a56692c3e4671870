"""CPU tests of the benchmark's harness: discovery by name, the window's
arithmetic under an injected clock, the frozen roofline and FLOP
arithmetic, the plain reference against the port's plain path, and what
the benchmark may import.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import io
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import registry, roofline, run, window
from benchmark.tests.tiny import TINY_INT8_LIMIT, TINY_LIMIT, make_root

PRODUCTION = registry.config(registry.load_spec(), "sams_int8")["options"]


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run_cell(root, cell, seconds=1.0, **kw):
    out, err = io.StringIO(), io.StringIO()
    rc = run.main(["--workload", cell, "--seed", "2147483659", "--seconds", str(seconds),
                   "--trace", "0"], root=root, device="cpu", check_device=False, out=out,
                  err=err, **kw)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


def test_new_config_traffic_and_metric_are_found_as_new_files(tmp_path):
    root = make_root(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "tiny.json").read_text())
    (bench / "configs" / "tiny_b.json").write_text(json.dumps({**cfg, "name": "tiny_b"}))
    mix = json.loads((bench / "traffic" / "tiny.sync.json").read_text())
    (bench / "traffic" / "tiny.solo.json").write_text(json.dumps({**mix, "batch": 1, "pool": 1}))
    (bench / "metrics" / "hand_ins.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.clips)) if ctx.window.clips else None\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({**spec["configs"][0], "name": "tiny_b",
                            "file": "benchmark/configs/tiny_b.json"})
    spec["workloads"].append({"name": "tiny_b.solo", "config": "tiny_b", "traffic": "tiny.solo",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][-1]["workloads"].append("tiny_b.solo")
    spec["per_layer"].append({"name": "hand_ins", "unit": "n", "better": "higher",
                              "source": "host_clock", "layer": "entry", "moves": "clip_p90_ms",
                              "workloads": ["tiny_b.solo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, line, err = run_cell(root, "tiny_b.solo")
    assert rc == 0 and line["correct"], err
    assert set(line["metrics"]) == {"setup_s", "clip_p90_ms"}
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks" and err.strip().splitlines()[-1].startswith("check ")
    spec = registry.load_spec(root)
    reader = registry.metric("hand_ins", bench)
    win = window.Window(clips=[window.Clip(0, 0.0, 0.1, 0.2)])
    assert [m["name"] for m in spec["per_layer"] if registry.applies(m, "tiny_b.solo")] == ["hand_ins"]
    assert reader.read(SimpleNamespace(window=win)) == 1.0
    assert reader.read(SimpleNamespace(window=window.Window())) is None


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def closed_loop(in_flight, stall_at=None, n_seconds=10.0, device_s=0.25, host_s=0.1):
    """A system whose host enqueue takes host_s and whose device takes
    device_s a batch (one device: batches run one after another), with one
    hand-in stalled by 2 s on the host."""
    clock = FakeClock()
    free_at = [0.0]

    class Handle:
        def __init__(self, done):
            self.done = done

        def wait(self):
            clock.t = max(clock.t, self.done)

    def submit(i):
        clock.t += host_s + (2.0 if i == stall_at else 0.0)
        free_at[0] = max(free_at[0], clock.t) + device_s
        return Handle(free_at[0])

    return window.run(submit, n_seconds, in_flight, clock)


@pytest.mark.parametrize("in_flight", [1, 2])
def test_a_stall_in_the_window_shows_end_to_end(in_flight):
    steady, stalled = closed_loop(in_flight), closed_loop(in_flight, stall_at=10)
    fps = [window.frames_per_s(w, 16, 5) for w in (steady, stalled)]
    p90 = [window.clip_p90_ms(w) for w in (steady, stalled)]
    assert fps[1] < fps[0] * 0.9
    assert p90[1] >= p90[0]
    short = [window.clip_p90_ms(closed_loop(1, stall_at=s, n_seconds=2.0)) for s in (None, 3)]
    assert short[1] > 2 * short[0]
    # the window ends with the last batch handed in: every clip counted, none dropped
    assert [c.index for c in stalled.clips] == list(range(len(stalled.clips)))
    assert stalled.end == max(c.done for c in stalled.clips)


def test_offline_rate_is_the_device_pace_and_sync_adds_the_host():
    off, sync = closed_loop(2), closed_loop(1)
    assert window.frames_per_s(off, 16, 5) == pytest.approx(80 / 0.25, rel=0.05)
    assert window.clip_p90_ms(sync) == pytest.approx(350.0)


def test_roofline_bounds_at_the_top_site():
    site = (4, 256, 192, 128, (4, 3, 3, 2))
    assert round(1e3 * roofline.chain_bound_bf16(*site), 4) == 0.4745
    assert round(1e3 * roofline.chain_bound_int8(*site), 4) == 0.2399
    # the chip_smoke.py row-2 bound counts the hidden conv a second time (the pre-pass)
    hidden = 2 * 9 * 4 * 256 * 192 * 12 * 128 / roofline.BF16_FLOPS
    assert round(1e3 * (roofline.chain_bound_int8(*site) + hidden), 4) == 0.2454


def test_mfu_flops_of_a_batch_16_clip():
    per_call = roofline.generator_flops(PRODUCTION, 16)
    assert round(per_call / 1e12, 2) == 12.35
    assert PRODUCTION["n_frames_total"] * per_call == pytest.approx(5 * 12.3517e12, rel=1e-4)
    sites = roofline.spade_sites(PRODUCTION, 16)
    assert len(sites) == 30 and sum(len(s[4]) for s in sites) == 4 * 3 + 4 * (6 + 12)


def test_reference_matches_the_ports_plain_path_f32(tmp_path):
    rc, line, err = run_cell(make_root(tmp_path), "tiny.sync")
    assert rc == 0 and line["correct"], err
    assert line["checks"]["frame_rel_rms"]["value"] < TINY_LIMIT


def test_reference_int8_matches_the_ports_plain_int8_path():
    """The port's plain int8 clip (f32 around the int8 convs) against the
    8-bit reference: only quantization flips from f32 summation orders
    separate them, far under the 4-bit control (see tiny.TINY_INT8_LIMIT)."""
    from benchmark.entries import sams_clip as E
    from benchmark.tests.tiny import TINY_OPTIONS

    cfg = registry.config(registry.load_spec(), "sams_int8")
    cfg = {**cfg, "options": {**cfg["options"], **TINY_OPTIONS, "n_frames_total": 2,
                              "n_frames_now": 2}}
    mix = {"batch": 1, "pool": 1, "in_flight": 1}
    served = E.build(cfg, mix, 5, "cpu")
    with torch.no_grad():
        frames = {0: served.one_clip(served.traffic.hand_in(0))}
    got = E.judge(frames, served.traffic, served.weights, cfg["options"], 8)
    assert got["frame_rel_rms"] < TINY_INT8_LIMIT and got["nonfinite"] == 0


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "shineon_tpu"}


def _root_modules() -> set:
    root = registry.ROOT
    names = {p.stem for p in root.glob("*.py")}
    names |= {p.name for p in root.iterdir() if p.is_dir() and (p / "__init__.py").exists()}
    return names | {"tools", "tests", "fixtures"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_imports():
    bench = registry.BENCH_DIR
    banned = FORBIDDEN | (_root_modules() - {"benchmark", "shineon_tpu_torch"})
    files = [p for p in bench.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    for p in files:
        assert not (_imports(p) & banned), (p, _imports(p) & banned)
    for p in (bench / "reference").rglob("*.py"):
        assert "shineon_tpu_torch" not in _imports(p), p


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "shineon_tpu_torchy.sub", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("y"))
    assert run.forbidden_modules() == ["flax"]


def test_trace_reduction_and_the_readers_of_a_trace():
    from benchmark import trace as tracing

    mark = "sleep"
    dev = [(mark, 0, 1), ("chain_kernel_q_bf16<0>", 1, 41), ("Memcpy HtoD", 41, 45),
           ("hidden_absmax_kernel<bf16, 0>", 60, 70),  # idle 45..60 under host op "aten::copy_"
           (mark, 100, 101), ("chain_kernel_q_bf16<0>", 101, 141), ("hidden_absmax_kernel<bf16, 0>", 141, 151),
           ("dropped", -50, -40)]  # before the first marker: not counted
    host = [("one_clip", 0, 160), ("aten::copy_", 44, 62), ("cudaLaunchKernel", 71, 72)]
    tr = tracing.reduce(dev, host, lambda n: n == mark)
    assert [len(c) for c in tr.clips] == [3, 2] and tr.window == (0, 151)
    # of three or more marked clips the first, which may have lost events, is left out
    three = tracing.reduce(dev + [(mark, 200, 201), ("k", 201, 210)], host, lambda n: n == mark)
    assert [len(c) for c in three.clips] == [2, 1] and three.window == (100, 210)
    assert tracing.busy_s(tr) == pytest.approx((40 + 4 + 10 + 50) / 1e6)  # markers not counted
    gaps = dict(tracing.idle_gaps(tr))
    assert gaps["aten::copy_"] == pytest.approx(15 / 1e6 / 2)
    assert gaps["one_clip"] == pytest.approx(31 / 1e6 / 2)  # 70..101: only the clip's own op runs
    assert tracing.top_ops(tr)[0] == ["chain_kernel_q_bf16<0>", 40 / 1e6]
    ctx = SimpleNamespace(trace=tr, opt=PRODUCTION, batch=16, frames=5, memory_peak_bytes=2 ** 31,
                          window=window.Window())
    bench = registry.BENCH_DIR
    assert registry.metric("launches_per_clip.sync", bench).read(ctx) == 2.0
    idle = registry.metric("device_idle.sync", bench).read(ctx)
    assert idle == pytest.approx(100 * (1 - 104 / 151))
    assert registry.metric("device_idle.offline", bench).read(ctx) == idle
    roof = registry.metric("spade_chain_int8_roofline", bench).read(ctx)
    assert roof == pytest.approx(100 * roofline.clip_chain_bound(PRODUCTION, 16, True) / (50e-6))
    assert registry.metric("spade_chain_bf16_roofline", bench).read(ctx) is None
    assert registry.metric("peak_mem_gib", bench).read(ctx) == 2.0
    assert registry.metric("dispatch_ms.sync", bench).read(ctx) is None
    mfu = registry.metric("mfu", bench).read(ctx)
    assert mfu == pytest.approx(100 * 5 * roofline.generator_flops(PRODUCTION, 16) * 2 / 151e-6 / 989e12)
