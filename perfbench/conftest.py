"""Fixtures of the benchmark's own tests: runs of a cell's driver on the CPU
at a size a test holds, and the ``cuda`` fixture that skips a test where
torch sees no card."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench.harness.cell import Cell
from perfbench.harness.context import Context

# test sizes: 160² (a 5 x 5 grid), a few frames a call, the objectness
# logit at -4 so that a few frames hold picks, cameras at a rate that a
# loaded CPU keeps up with; the rest as committed
SMALL = {
    "detect-b128": {"batch": 4, "pool": 8, "warmup_calls": 1, "sample_calls": 2},
    "train-b16": {"batch": 4, "pool_batches": 4},
    "cameras-under-knee": {"cameras": 4, "fps": 10, "pool": 16, "batch": 8, "pad_to": 4,
                           "timeout_s": 0.2, "lead_in_s": 0.3, "sample_calls": 2},
}


def small_run(workload: str, seed: int = 5, program: str = "port", fault=None,
              seconds: float = 0.5):
    """One run of ``workload``'s driver on the CPU at the test size, on one
    thread as ``run.py`` runs (an open loop on many threads of a loaded CPU
    falls behind its cameras); the test's thread count is restored after."""
    cell = Cell(workload)
    traffic = workload.split(".", 1)[1]
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                  device=torch.device("cpu"), t_process=time.perf_counter(),
                  overrides={"config": {"size": 160, "objectness_logit": -4.0},
                             "traffic": SMALL[traffic]},
                  program=program, fault=fault)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cell, cell.driver.run(ctx)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees none")
    return torch.device("cuda", 0)
