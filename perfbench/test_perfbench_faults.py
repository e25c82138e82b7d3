"""A run with the timed path broken underneath reads ``correct`` false, and
a sound run reads it true, under each cell's committed limits (the driver
on the CPU at the test size; the chip's check is skipped)."""

from __future__ import annotations

import pytest

from perfbench.conftest import small_run
from perfbench.harness.compare import judge

CASES = [("darknet19-voc416.detect-b128", f) for f in (None, "half_batch", "alter_answer")]
CASES += [("mobilenet-voc416.detect-b128", f) for f in (None, "half_batch", "alter_answer")]
CASES += [("darknet19-voc416.cameras-under-knee", f) for f in (None, "half_batch", "alter_answer")]
CASES += [("darknet19-voc416.train-b16", f) for f in (None, "half_batch", "unchanged_state")]


@pytest.mark.parametrize("workload,fault", CASES, ids=lambda v: str(v))
def test_fault_reads_not_correct(workload, fault):
    cell, out = small_run(workload, fault=fault)
    correct, rows = judge(out.numbers, cell.limits)
    assert out.failed == 0
    assert correct is (fault is None), rows
