"""The camera cell's schedule and its latency statistic."""

from __future__ import annotations

import numpy as np

from perfbench.conftest import SMALL, small_run
from perfbench.harness.cell import Cell


def test_schedule_repeats_from_its_seed_and_every_seed_offers_the_same_arrivals():
    drv = Cell("darknet19-voc416.cameras-under-knee").driver
    traffic = Cell("darknet19-voc416.cameras-under-knee").traffic
    due, rows = drv.schedule(traffic, 2**33 + 1, 3.0)
    again, rows_again = drv.schedule(traffic, 2**33 + 1, 3.0)
    other, rows_other = drv.schedule(traffic, 7, 3.0)
    assert np.array_equal(due, again) and np.array_equal(rows, rows_again)
    assert np.allclose(due, other) and not np.array_equal(rows, rows_other)
    n, fps = traffic["cameras"], traffic["fps"]
    assert len(due) == n * fps * (traffic["lead_in_s"] + 3.0)
    assert np.all(np.diff(due) > 0) and np.allclose(np.diff(due), 1 / (n * fps))


def test_p95_is_over_every_frame_due_in_the_window(monkeypatch):
    drv = Cell("darknet19-voc416.cameras-under-knee").driver
    seen = {}
    real = np.percentile

    def spy(values, q, *args, **kw):
        seen.setdefault("sizes", []).append(len(values))
        return real(values, q, *args, **kw)

    monkeypatch.setattr(drv.np, "percentile", spy)
    cell, out = small_run("darknet19-voc416.cameras-under-knee", seconds=0.6)
    traffic = dict(cell.traffic, **SMALL["cameras-under-knee"])
    due, _ = drv.schedule(traffic, 5, 0.6)
    window = int((due >= traffic["lead_in_s"]).sum())
    assert out.attempted == window and out.failed == 0
    assert seen["sizes"] == [window]
