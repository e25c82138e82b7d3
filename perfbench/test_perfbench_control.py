"""The check's control on the card: the reference rounded to fp8 in the
program's place reads ``correct`` false in every cell (a short window, at the
cells' own sizes).  Needs an NVIDIA GPU:

    python -m pytest perfbench/test_perfbench_control.py
"""

from __future__ import annotations

import time

import pytest

from perfbench.harness.cell import Cell
from perfbench.harness.compare import judge
from perfbench.harness.context import Context

CELLS = ["darknet19-voc416.detect-b128", "mobilenet-voc416.detect-b128",
         "darknet19-voc416.train-b16", "darknet19-voc416.cameras-under-knee"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_not_correct(workload, cuda):
    cell = Cell(workload)
    ctx = Context(cell=cell, seed=3000000201, seconds=1.0, trace=False, device=cuda,
                  t_process=time.perf_counter(), program="control")
    correct, rows = judge(cell.driver.run(ctx).numbers, cell.limits)
    assert not correct, rows
