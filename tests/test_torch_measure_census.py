"""The port's FLOP census (shineon_tpu_torch/tools/flop_census.py) and
conv roof census (tools/serving_roof_census.py) on the CPU: the census of
the TINY fp generator (test_torch_serving.py's options) against the JAX
census (tools/flop_census.py::census) of the lowered TINY JAX
generate_n_frames(train=False), shape by shape; at the production widths,
counted at 64x48 and scaled by 16, against the analytic count; every key
against the JAX roof census's SHAPE_RE; the roof census's sums and
misgated flags from an injected timer."""

import ast
import json
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _raw_batch, _sams_opt
from shineon_tpu.models.sams_model import SamsModel as JSamsModel
from shineon_tpu_torch import convert
from shineon_tpu_torch.bench import analytic_generator_flops
from shineon_tpu_torch.models.sams_model import SamsModel
from shineon_tpu_torch.options import sams_options
from shineon_tpu_torch.serving import frame_inputs, gen_frame
from shineon_tpu_torch.tools import flop_census
from shineon_tpu_torch.tools import serving_roof_census as roof
from test_torch_networks import one_torch_thread  # noqa: F401 (autouse)
from test_torch_serving import TINY, _np
from tools.flop_census import census as jax_census

REPO = Path(__file__).resolve().parents[1]


def jax_shape_re():
    """SHAPE_RE of tools/serving_roof_census.py, read from its source (the
    module enables a persistent compilation cache when imported)."""
    tree = ast.parse((REPO / "tools" / "serving_roof_census.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "SHAPE_RE":
            return re.compile("".join(ast.literal_eval(a) for a in node.value.args))
    raise AssertionError("no SHAPE_RE in tools/serving_roof_census.py")


def by_shape(convs):
    """{shape: [count, flops]} over every route."""
    out = defaultdict(lambda: [0, 0.0])
    for c in convs:
        out[c["shape"]][0] += c["count"]
        out[c["shape"]][1] += c["flops"]
    return dict(out)


@pytest.fixture(scope="module")
def tiny_census():
    """The port's census of one TINY generator forward (batch 2, f32, no
    scaling) and the JAX census of the lowered TINY clip, with the same
    weights."""
    mp = pytest.MonkeyPatch()
    mp.setenv("SHINEON_FUSED_SPADE", "1")
    try:
        jsams = JSamsModel(_sams_opt(is_train=False, **TINY))
        g = jsams.init_state(jax.random.PRNGKey(420), 1).nets["generator"]
        raw = _raw_batch(_sams_opt(**TINY), batch=2)
        feats = jax.jit(jsams.features)(raw)
        text = jax.jit(lambda p, s, f: jsams.generate_n_frames(p, s, f, train=False)[2]).lower(
            g.params, g.stats, feats).as_text()
    finally:
        mp.undo()
    jtotal, jshapes = jax_census(text)
    sams = SamsModel(sams_options(**TINY), device="cpu")
    convert.load_flax(sams.generator, _np({"params": g.params, **g.stats}),
                      convert.GENERATOR_RENAMES)
    with torch.no_grad():
        tfeats = sams.features({k: torch.from_numpy(v) for k, v in raw.items()})
    window, prev_maps, current_maps = frame_inputs(sams, tfeats)
    mine = flop_census.count_convs(lambda: gen_frame(sams, window, prev_maps, current_maps))
    return mine, jtotal, jshapes


def test_tiny_census_equals_jax_census(tiny_census):
    """Shape by shape, the same count and FLOPs as the JAX census of the
    lowered clip (whose 3-frame loop body lowers once: one forward), and
    the same total."""
    mine, jtotal, jshapes = tiny_census
    ref = {k: [n, fl] for k, (n, fl) in jshapes.items()}
    assert by_shape(mine["convs"]) == ref
    assert mine["total_flops"] == jtotal


def test_tiny_census_routes(tiny_census):
    """Every conv of the fp graph runs in the fused chain or in cuDNN; the
    chain's convs are its hidden conv (128 out) and its [gamma | beta]
    conv (128 in)."""
    mine, _, _ = tiny_census
    routes = {c["route"] for c in mine["convs"]}
    assert routes == {flop_census.ROUTE_CHAIN, flop_census.ROUTE_CUDNN}
    for c in mine["convs"]:
        kh, kw, cin, cout, *_ = roof.parse_shape(c["shape"])
        if c["route"] == flop_census.ROUTE_CHAIN:
            assert (kh, kw) == (3, 3) and 128 in (cin, cout), c


def test_census_keys_match_the_jax_shape_re(tiny_census):
    """Every key the port's census writes parses with the JAX roof census's
    SHAPE_RE, which the port's copy equals."""
    pattern = jax_shape_re()
    assert roof.SHAPE_RE.pattern == pattern.pattern
    mine, _, _ = tiny_census
    keys = [c["shape"] for c in mine["convs"]]
    keys += [c["shape"] for c in flop_census.generator_census(2, int8=True, **{
        k: v for k, v in TINY.items() if k not in ("fine_height", "fine_width", "batch_size")})[
        "convs"]]
    assert keys and all(pattern.fullmatch(k) for k in keys), keys


def test_full_width_census_agrees_with_the_analytic_count():
    """The production widths counted at 64x48, batch 1, scaled by 16 and to
    batch 16: within 10% of analytic_generator_flops (it is exact), the
    largest conv the 256x192 chain's [gamma | beta] conv at C = 128, and
    the int8 graph's convs the same FLOPs, keyed [i8] where the int8 conv
    or the quantized chain runs them."""
    fp = flop_census.generator_census(16)
    analytic = analytic_generator_flops(16)
    assert abs(fp["total_flops"] / analytic - 1) < flop_census.TOLERANCE
    assert fp["convs"][0]["shape"] == "conv 3x3x128x256 -> 16x256x192x256 [bf16]"
    assert fp["convs"][0]["route"] == flop_census.ROUTE_CHAIN
    q = flop_census.generator_census(16, int8=True)
    assert q["total_flops"] == fp["total_flops"]
    for c in q["convs"]:
        dtype = roof.parse_shape(c["shape"])[-1]
        if c["route"] == flop_census.ROUTE_INT8_CONV:
            assert dtype == "i8", c
    assert {c["route"] for c in q["convs"]} == {
        flop_census.ROUTE_CHAIN_INT8, flop_census.ROUTE_INT8_CONV, flop_census.ROUTE_CUDNN}


def test_roof_census_sums_and_misgated_from_an_injected_timer():
    """The JAX tool's sums over count x the graph's formulation, the best
    dispatch, the clip's 5 forwards, the per-route sums beside a traced
    clip, and misgated: int8_conv_profitable against the faster
    formulation, for the gated routes only."""
    census = {"batch": 4, "int8": True, "n_frames": 5, "convs": [
        # gated int8 conv, int8 faster: not misgated
        {"shape": "conv 3x3x128x128 -> 4x64x48x128 [i8]", "count": 2, "flops": 2e11,
         "route": roof.ROUTE_INT8_CONV},
        # gated int8 conv, bf16 faster: misgated
        {"shape": "conv 3x3x64x64 -> 4x64x48x64 [i8]", "count": 3, "flops": 1e11,
         "route": roof.ROUTE_INT8_CONV},
        # under the gate (Cin 12 < 64) on cuDNN, int8 faster: misgated
        {"shape": "conv 3x3x12x64 -> 4x64x48x64 [bf16]", "count": 1, "flops": 5e10,
         "route": roof.ROUTE_CUDNN},
        # a 1x1 conv: no int8 route
        {"shape": "conv 1x1x64x128 -> 4x64x48x128 [bf16]", "count": 1, "flops": 3e10,
         "route": roof.ROUTE_CUDNN},
        # the quantized chain's conv: the gate does not route it
        {"shape": "conv 3x3x128x256 -> 4x64x48x256 [i8]", "count": 4, "flops": 4e11,
         "route": roof.ROUTE_CHAIN_INT8},
        # below --min_tflop: not timed
        {"shape": "conv 3x3x4x128 -> 4x64x48x128 [bf16]", "count": 1, "flops": 1e9,
         "route": roof.ROUTE_CHAIN_INT8},
    ]}
    times = {(128, 128): (2.0, 1.0), (64, 64): (1.0, 1.5), (12, 64): (0.5, 0.25),
             (64, 128): (0.75, None), (128, 256): (4.0, 3.0)}
    timed = []

    def timer(kh, kw, cin, cout, B, H, W):
        timed.append((kh, kw, cin, cout, B, H, W))
        bf16, i8 = times[cin, cout]
        return {"bf16_ms": bf16} if i8 is None else {"bf16_ms": bf16, "i8_ms": i8,
                                                      "i8_conv_ms": i8 / 2}

    rows = roof.roof_rows(census, timer, min_tflop=0.01)
    assert len(rows) == 5 and (3, 3, 4, 128, 4, 64, 48) not in timed
    assert [r["misgated"] for r in rows] == [False, True, True, None, None]
    assert [r["graph_ms_total"] for r in rows] == [2.0, 4.5, 0.5, 0.75, 12.0]
    assert [r["best_ms_total"] for r in rows] == [2.0, 3.0, 0.25, 0.75, 12.0]
    assert rows[0]["tops_graph"] == pytest.approx(1e11 / 1e-3 / 1e12)
    traced = {"busy_ms": 90.0, "wall_ms": 150.0, "other_ms": 15.0,
              "routes": {roof.ROUTE_INT8_CONV: 20.0, roof.ROUTE_CHAIN_INT8: 50.0,
                         roof.ROUTE_CUDNN: 5.0}}
    s = roof.roof_summary(rows, 5, traced)
    assert s["conv_roof_ms_per_forward"] == pytest.approx(19.75)
    assert s["conv_roof_ms_best_dispatch"] == pytest.approx(18.0)
    assert s["clip_conv_roof_ms"] == pytest.approx(98.75)
    assert s["misgated"] == [rows[1]["shape"], rows[2]["shape"]]
    assert s["routes"] == {
        roof.ROUTE_INT8_CONV: {"isolated_clip_ms": 32.5, "traced_clip_ms": 20.0},
        roof.ROUTE_CUDNN: {"isolated_clip_ms": 6.25, "traced_clip_ms": 5.0},
        roof.ROUTE_CHAIN_INT8: {"isolated_clip_ms": 60.0, "traced_clip_ms": 50.0}}
    assert s["clip_busy_ms"] == 90.0 and s["clip_other_ms"] == 15.0


def test_roof_census_times_a_small_census_on_the_cpu(tmp_path):
    """The command line with --device cpu on a census of two small shapes:
    a line a shape (the int8 call on the 3x3 shape only) and the
    summary."""
    census = {"batch": 1, "int8": True, "n_frames": 5, "convs": [
        {"shape": "conv 3x3x16x16 -> 1x8x6x16 [i8]", "count": 2, "flops": 2e10,
         "route": roof.ROUTE_INT8_CONV},
        {"shape": "conv 1x1x16x32 -> 1x8x6x32 [bf16]", "count": 1, "flops": 2e10,
         "route": roof.ROUTE_CUDNN}]}
    path = tmp_path / "census.json"
    path.write_text(json.dumps(census))
    proc = subprocess.run([sys.executable, "-m", "shineon_tpu_torch.tools.serving_roof_census",
                           "--census", str(path), "--iters", "1", "--device", "cpu"],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["shape"] for r in lines[:2]] == [c["shape"] for c in census["convs"]]
    assert lines[0]["i8_ms"] > 0 and lines[1]["i8_ms"] is None
    assert lines[2]["device"] == "cpu" and lines[2]["card"] is None
    assert np.isfinite(lines[2]["conv_roof_ms_per_forward"])
