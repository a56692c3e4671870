"""The port's spans (shineon_tpu_torch/tracing.py) on the CPU: off by
default and then recording nothing; on inside a torch.profiler session,
where each span is a host event of the profile and not a user annotation;
parents and request ids; the serving clip's spans at the benchmark's tiny
options; the set-up spans, which record with spans off; the benchmark's
readers of the spans (benchmark/metrics/host_ms.*.py, kernel_load_s.py,
warm_up_s.py) on hand-built windows and spans under an injected clock;
``SHINEON_SPANS``'s Chrome trace."""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import shineon_tpu_torch
from benchmark import registry, window
from benchmark.tests.tiny import TINY_OPTIONS
from shineon_tpu_torch import serving, tools, tracing
from shineon_tpu_torch.networks.sams import spade as spade_module
from shineon_tpu_torch.ops import cuda_build

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the tensors are small, and the suite's parallel
    workers would otherwise fight for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_spans(monkeypatch):
    """Each test starts with no spans and spans off, and leaves them so."""
    monkeypatch.setattr(tracing, "_on", False)
    monkeypatch.setattr(tracing, "_path", None)
    tracing.reset()
    yield
    tracing.reset()


def by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def test_off_records_nothing_and_costs_one_shared_context():
    assert not tracing._on
    before = tracing._request
    with tracing.request():
        with tracing.span("spade.chain"):
            torch.ones(3).add_(1)
    assert tracing.spans() == [] and tracing.totals() == {}
    assert tracing.span("a") is tracing.span("b") is tracing.request()
    assert tracing._request == before + 2  # one_clip calls are counted all the same
    assert not tracing._on


def test_spans_record_inside_a_profiler_session_as_host_events():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.request():
            with tracing.span("spade.chain"):
                torch.ones(8).mul_(2)
    assert [s.name for s in tracing.spans()] == ["spade.chain", "serving.one_clip"]
    events = {e.name: e for e in prof.events() if e.name in ("spade.chain", "serving.one_clip")}
    assert set(events) == {"spade.chain", "serving.one_clip"}
    for e in events.values():
        assert e.is_user_annotation is False
        assert e.device_type.name == "CPU"
    # the session over, spans are off again
    with tracing.span("after"):
        pass
    assert len(tracing.spans()) == 2 and not tracing._on


def test_parents_and_request_ids_nest():
    tracing.enable()
    with tracing.setup("setup.warm_up"):
        pass
    first = tracing._request + 1
    for _ in range(2):
        with tracing.request():
            with tracing.span("serving.gen_scan"):
                for _ in range(2):
                    with tracing.span("sams.frame"):
                        with tracing.span("spade.chain"):
                            pass
    spans = tracing.spans()
    ids = {s.id: s for s in spans}
    names = by_name(spans)
    assert names["setup.warm_up"][0].parent == 0
    assert [s.request for s in names["serving.one_clip"]] == [first, first + 1]
    for s in spans:
        if s.name == "setup.warm_up":
            continue
        assert s.request in (first, first + 1)
        if s.name != "serving.one_clip":
            outer = ids[s.parent]
            assert outer.request == s.request
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert {ids[s.parent].name for s in names["spade.chain"]} == {"sams.frame"}
    assert {ids[s.parent].name for s in names["sams.frame"]} == {"serving.gen_scan"}
    assert {ids[s.parent].name for s in names["serving.gen_scan"]} == {"serving.one_clip"}
    assert tracing.totals()["spade.chain"][0] == 4


@pytest.fixture(scope="module")
def tiny_clip():
    """The serving clip at the benchmark's tiny options on the CPU, warmed
    with spans off: (one_clip, sams, raw batch, set-up spans)."""
    assert not tracing._on
    tracing.reset()
    torch.set_num_threads(1)
    warp, sams, raw = serving.build_models(2, device="cpu", **TINY_OPTIONS)
    serving.warm_up(sams, raw, rollouts=1)
    setup = (tracing.spans(), tracing.totals())
    tracing.reset()
    return serving.make_one_clip(warp, sams), sams, raw, setup


def test_warm_up_records_with_spans_off(tiny_clip):
    spans, totals = tiny_clip[3]
    assert [s.name for s in spans] == ["setup.warm_up"]
    assert totals["setup.warm_up"][0] == 1 and totals["setup.warm_up"][1] > 0
    assert spans[0].end_ns - spans[0].start_ns == totals["setup.warm_up"][1]


def test_serving_clip_spans(tiny_clip, monkeypatch):
    one_clip, sams, raw, _ = tiny_clip
    sites = []
    chain = spade_module.fused_multispade_modulate

    def counted(*args, **kwargs):
        sites.append(args[0].shape)
        return chain(*args, **kwargs)

    monkeypatch.setattr(spade_module, "fused_multispade_modulate", counted)
    calls = 2
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(calls):
            one_clip(raw)
    spans = tracing.spans()
    ids = {s.id: s for s in spans}
    names = by_name(spans)
    n_frames = sams.n_frames_total
    roots = names["serving.one_clip"]
    assert len(roots) == calls
    assert len({s.request for s in roots}) == calls
    for stage in ("serving.features", "serving.gmm_warp", "serving.gen_scan"):
        assert len(names[stage]) == calls
        assert all(ids[s.parent].name == "serving.one_clip" for s in names[stage])
    assert len(names["sams.frame"]) == calls * n_frames
    assert all(ids[s.parent].name == "serving.gen_scan" for s in names["sams.frame"])
    assert len(sites) % (calls * n_frames) == 0 and sites
    assert len(names["spade.chain"]) == len(sites)
    assert {ids[s.parent].name for s in names["sams.resblock"]} == {"sams.frame"}
    assert {ids[s.parent].name for s in names["spade.chain"]} <= {"sams.resblock", "sams.frame"}
    for root in roots:
        inside = [s for s in spans if s.request == root.request and s is not root]
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in inside)
        stages = sum(s.end_ns - s.start_ns for s in inside if s.name in
                     ("serving.features", "serving.gmm_warp", "serving.gen_scan"))
        assert stages <= root.end_ns - root.start_ns
    # the int8 conv's span is on its CUDA path alone: none on the CPU
    assert "int8.conv3x3" not in names


def test_kernel_load_is_a_set_up_span_once_a_library(monkeypatch):
    built = []
    monkeypatch.setattr(cuda_build, "build", lambda name: built.append(name) or "")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: SimpleNamespace(path=path))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    a = cuda_build.load_library("fused_multispade")
    assert cuda_build.load_library("fused_multispade") is a
    cuda_build.load_library("int8_conv3x3")
    assert built == ["fused_multispade", "int8_conv3x3"]
    assert tracing.totals()["setup.kernel_load"][0] == 2
    assert not tracing._on


def test_tools_keep_the_counters():
    assert tools.serving_counters is tracing.serving_counters
    assert tools.launch_counts is tracing.launch_counts
    counts = tools.launch_counts()
    assert set(counts) == set(tracing.serving_counters()) and all(v >= 0 for v in counts.values())


class Clock:
    """An injected clock: tracing's ns clock and the window's seconds."""

    def __init__(self):
        self.ns = 0

    def at(self, seconds: float):
        self.ns = round(seconds * 1e9)

    def __call__(self):
        return self.ns


def record_hand_in(clock, t0, stage_ms, chains_ms, convs_ms):
    """One hand-in's spans, on ``clock``, beginning 1 ms after ``t0`` (s):
    its stages of ``stage_ms`` (features, gmm_warp, gen_scan) in turn, the
    chain and conv spans inside gen_scan; one_clip ends 1 ms after them."""
    t = t0 + 1e-3
    clock.at(t)
    with tracing.request():
        for name, ms in zip(("serving.features", "serving.gmm_warp", "serving.gen_scan"),
                            stage_ms):
            clock.at(t)
            with tracing.span(name):
                if name == "serving.gen_scan":
                    u = t
                    for inner, durations in (("spade.chain", chains_ms),
                                             ("int8.conv3x3", convs_ms)):
                        for d in durations:
                            clock.at(u)
                            with tracing.span(inner):
                                u += d / 1e3
                                clock.at(u)
                t += ms / 1e3
                clock.at(t)
        clock.at(t + 1e-3)


# hand-ins 0-1 untraced, 2-5 traced (2 and 3 the device-only half, read)
HAND_INS = [  # (traced, stage ms, chain ms, conv ms)
    (False, (9, 9, 90), (5, 5), (1,)),
    (False, (9, 9, 90), (5, 5), (1,)),
    (True, (3, 4, 81), (2, 3), (1, 1)),
    (True, (5, 6, 85), (4, 4), (2,)),
    (True, (30, 40, 800), (20, 30), (10,)),
    (True, (30, 40, 800), (20, 30), (10,)),
]
EXPECTED = {  # mean over hand-ins 2 and 3, ms
    "host_ms.one_clip.sync": ((3 + 4 + 81 + 1) + (5 + 6 + 85 + 1)) / 2,
    "host_ms.one_clip.offline": ((3 + 4 + 81 + 1) + (5 + 6 + 85 + 1)) / 2,
    "host_ms.features.sync": (3 + 5) / 2,
    "host_ms.gmm_warp.sync": (4 + 6) / 2,
    "host_ms.gen_scan.sync": (81 + 85) / 2,
    "host_ms.spade_chain.sync": (5 + 8) / 2,
    "host_ms.spade_chain.offline": (5 + 8) / 2,
    "host_ms.int8_conv.sync": (2 + 2) / 2,
    "kernel_load_s": 1.5 + 0.25,
    "warm_up_s": 4.0,
}


def hand_built_ctx(clock):
    """A window of HAND_INS a second apart (handed at i + 10 s, returned
    0.2 s later) with their spans recorded on ``clock``, and the set-up
    spans before it."""
    tracing.enable()
    for name, start, seconds in (("setup.kernel_load", 1.0, 1.5), ("setup.kernel_load", 3.0, 0.25),
                                 ("setup.warm_up", 4.0, 4.0)):
        clock.at(start)
        with tracing.setup(name):
            clock.at(start + seconds)
    win = window.Window()
    for i, (traced, stages, chains, convs) in enumerate(HAND_INS):
        t0 = 10.0 + i
        record_hand_in(clock, t0, stages, chains, convs)
        win.clips.append(window.Clip(i, t0, t0 + 0.2, t0 + 0.5, traced=traced))
    win.start, win.end = 10.0, 10.0 + len(HAND_INS)
    tracing._on = False
    return SimpleNamespace(window=win)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_span_readers_on_a_hand_built_window(metric, monkeypatch):
    clock = Clock()
    monkeypatch.setattr(tracing, "_clock", clock)
    ctx = hand_built_ctx(clock)
    spec = {m["name"]: m for m in registry.load_spec(REPO)["per_layer"]}
    assert spec[metric]["source"] == "host_clock" and spec[metric]["workloads"]
    reader = registry.metric(metric)
    assert reader.read(ctx) == pytest.approx(EXPECTED[metric], rel=1e-6)
    with monkeypatch.context() as m:  # a program without spans, as before them
        m.delattr(shineon_tpu_torch, "tracing")
        m.setitem(sys.modules, "shineon_tpu_torch.tracing", None)
        assert reader.read(ctx) is None
    tracing.reset()
    assert reader.read(ctx) is None


def test_span_readers_skip_hand_ins_outside_the_window(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(tracing, "_clock", clock)
    ctx = hand_built_ctx(clock)
    reader = registry.metric("host_ms.one_clip.sync")
    for c in ctx.window.clips:  # no one_clip began inside any hand-in now
        c.handed, c.returned = c.handed + 0.5, c.returned + 0.5
    assert reader.read(ctx) is None


def test_shineon_spans_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "spans.json"
    code = ("from shineon_tpu_torch import tracing\n"
            "with tracing.request():\n"
            "    with tracing.span('spade.chain'):\n"
            "        pass\n")
    before = time.time_ns()
    env = {**os.environ, tracing.ENV: str(path)}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
    after = time.time_ns()
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    assert [e["name"] for e in events] == ["spade.chain", "serving.one_clip"]
    chain, root = events
    for e in events:
        assert e["ph"] == "X" and e["dur"] >= 0 and before / 1e3 <= e["ts"] <= after / 1e3
    assert root["ts"] <= chain["ts"] and chain["ts"] + chain["dur"] <= root["ts"] + root["dur"]
    assert chain["args"]["parent"] == root["args"]["id"]
    assert chain["args"]["request"] == root["args"]["request"] == 1
