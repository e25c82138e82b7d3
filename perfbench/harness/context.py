"""What a driver is handed (``Context``) and what it hands back
(``Outcome``)."""

from __future__ import annotations

import dataclasses
import time

import torch

__all__ = ["Context", "Outcome"]


@dataclasses.dataclass
class Context:
    """One run of one cell.  ``overrides`` ({"config": {...}, "traffic":
    {...}}) and ``program`` ("port", or "control": the reference in fp8 in
    the program's place) and ``fault`` (``faults.py``) exist for the
    calibration and the tests; a benchmark run leaves them alone."""

    cell: object
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_process: float
    overrides: dict = dataclasses.field(default_factory=dict)
    program: str = "port"
    fault: str | None = None
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, what: str) -> None:
        """Note the time at which the phase ``what`` of the run ended."""
        self.marks.append((what, time.perf_counter()))

    @property
    def config(self) -> dict:
        return {**self.cell.config, **self.overrides.get("config", {})}

    @property
    def traffic(self) -> dict:
        return {**self.cell.traffic, **self.overrides.get("traffic", {})}

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def memory_peak(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device)) if self.cuda else 0


@dataclasses.dataclass
class Outcome:
    end_to_end: dict            # {metric: value} of the window
    numbers: dict               # the compared numbers (``compare.py``)
    attempted: int
    failed: int
    memory_peak_bytes: int
    record: dict | None = None  # what the per-layer metrics read (``--trace 1``)
