"""The run with its timed path broken underneath: ``correct`` has to come
out false for each fault a serving cell can have (a state left unchanged,
half of the batch left out, an answer altered where it is produced; one
chip, so no exchange between chips; the SPADE chains without their
[gamma | beta] modulation; in int8, the hidden map quantized with the wrong
scale), and true without a fault. Tiny f32 and int8 cells on the CPU; the
chip check is skipped.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark import faults
from benchmark.tests.test_bench_harness import few_threads, run_cell  # noqa: F401
from benchmark.tests.tiny import make_root


CASES = ([(False, cell, fault) for cell in ("tiny.offline", "tiny.sync")
          for fault in (None, *faults.NAMES, "no_modulation")]
         + [(True, "tiny.sync", fault) for fault in (None, "no_modulation", "hidden_scale")])


@pytest.mark.parametrize("int8,cell,fault", CASES)
def test_a_broken_timed_path_is_not_correct(tmp_path, int8, cell, fault):
    plant = None if fault is None else (lambda served: faults.plant(served, fault))
    rc, line, err = run_cell(make_root(tmp_path, int8=int8), cell, seconds=0.5, fault=plant)
    assert rc == 0, err
    assert line["correct"] is (fault is None), (line["checks"], err)
    if fault is not None:
        assert line["failed"] >= 1
