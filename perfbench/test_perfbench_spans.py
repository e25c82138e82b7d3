"""The per-layer metrics that read the program's spans
(``harness/spans.py``), on synthetic snapshots of the tracer."""

from __future__ import annotations

import itertools

import pytest

from perfbench.harness import spans as spans_mod
from perfbench.harness.cell import Cell

DETECT = "darknet19-voc416.detect-b128"
STREAM = "darknet19-voc416.cameras-under-knee"
TRAIN = "darknet19-voc416.train-b16"


def _snapshot(root: str, calls: list[dict[str, list[tuple[float, float]]]], dropped=0):
    """A tracer snapshot of ``calls``: each maps a child span's name to its
    (host ms, device ms) readings in that call, under one root ``root``."""
    ids = itertools.count(1)
    out = []
    for call in calls:
        rid = next(ids)
        for name, readings in call.items():
            for host, device in readings:
                out.append({"id": next(ids), "parent": rid, "root": rid, "name": name,
                            "t0_ns": 0, "t1_ns": int(host * 1e6), "host_ms": host,
                            "device_ms": device, "attrs": {}})
        out.append({"id": rid, "parent": None, "root": rid, "name": root, "t0_ns": 0,
                    "t1_ns": 0, "host_ms": 0.0, "device_ms": 0.0, "attrs": {}})
    return {"spans": out, "dropped": dropped, "counters": {}}


def _read(monkeypatch, workload, metric, record, snap):
    monkeypatch.setattr(spans_mod, "snapshot", lambda: snap)
    return Cell(workload).metric_reader(metric)(record)


DETECT_CALL = {"yolojax_torch.plan.epilogue": [(0.01, 1.0), (0.01, 0.5)],
               "yolojax_torch.plan.pool": [(0.01, 0.25)],
               "yolojax_torch.post": [(0.1, 0.03)],
               "yolojax_torch.forward": [(3.0, 40.0)]}


@pytest.mark.parametrize("metric,want", [("bias_leaky_ms.detect", 1.5), ("pool_ms.detect", 0.25),
                                         ("post_ms.detect", 0.03)])
def test_detect_device_metrics(monkeypatch, metric, want):
    snap = _snapshot("yolojax_torch.detect", [DETECT_CALL, DETECT_CALL])
    record = {"segment_calls": 2}
    assert _read(monkeypatch, DETECT, metric, record, snap) == pytest.approx(want)
    # a snapshot of another number of calls, or one that dropped spans, reads nothing
    assert _read(monkeypatch, DETECT, metric, {"segment_calls": 3}, snap) is None
    dropped = _snapshot("yolojax_torch.detect", [DETECT_CALL, DETECT_CALL], dropped=1)
    assert _read(monkeypatch, DETECT, metric, record, dropped) is None


@pytest.mark.parametrize("metric", ["bias_leaky_ms.detect", "host_forward_ms.stream",
                                    "host_optimizer_ms.train"])
def test_no_tracer_or_no_segment_reads_nothing(monkeypatch, metric):
    workload = {"detect": DETECT, "stream": STREAM, "train": TRAIN}[metric.rsplit(".", 1)[1]]
    record = {"segment_calls": 1, "segment_batches": [8], "segment_steps": 1}
    assert _read(monkeypatch, workload, metric, record, None) is None
    empty = {"spans": [], "dropped": 0, "counters": {}}
    assert _read(monkeypatch, workload, metric, record, empty) is None
    assert _read(monkeypatch, workload, metric, None, empty) is None


def test_a_span_without_device_events_reads_no_device_time(monkeypatch):
    call = {"yolojax_torch.plan.epilogue": [(0.01, None)]}
    snap = _snapshot("yolojax_torch.detect", [call])
    assert _read(monkeypatch, DETECT, "bias_leaky_ms.detect", {"segment_calls": 1}, snap) is None


@pytest.mark.parametrize("metric,name", [("host_forward_ms.stream", "yolojax_torch.forward"),
                                         ("host_post_ms.stream", "yolojax_torch.post")])
def test_stream_host_metrics_take_the_median_call(monkeypatch, metric, name):
    calls = [{name: [(ms, None)]} for ms in (3.0, 5.0, 4.0, 100.0)]
    snap = _snapshot("yolojax_torch.detect", calls)
    # the lead-in's calls are traced too: at least as many roots as counted calls
    assert _read(monkeypatch, STREAM, metric, {"segment_batches": [64] * 3}, snap) == 4.5
    assert _read(monkeypatch, STREAM, metric, {"segment_batches": [64] * 5}, snap) is None


@pytest.mark.parametrize("phase", ["forward", "loss", "backward", "optimizer"])
def test_train_host_metrics_take_the_median_step(monkeypatch, phase):
    name = f"yolojax_torch.train.{phase}"
    steps = [{name: [(ms, 1.0)], "yolojax_torch.train.other": [(50.0, 1.0)]}
             for ms in (10.0, 12.0, 11.0)]
    snap = _snapshot("yolojax_torch.train_step", steps)
    metric = f"host_{phase}_ms.train"
    assert _read(monkeypatch, TRAIN, metric, {"segment_steps": 3}, snap) == 11.0
    assert _read(monkeypatch, TRAIN, metric, {"segment_steps": 4}, snap) is None
    detect_roots = _snapshot("yolojax_torch.detect", steps)
    assert _read(monkeypatch, TRAIN, metric, {"segment_steps": 3}, detect_roots) is None


def test_spans_of_other_roots_are_left_out(monkeypatch):
    snap = _snapshot("yolojax_torch.detect", [DETECT_CALL])
    stray = _snapshot("yolojax_torch.train_step", [DETECT_CALL])["spans"]
    for s in stray:
        s["id"] += 100
        s["root"] += 100
        s["parent"] = None if s["parent"] is None else s["parent"] + 100
    snap["spans"] += stray
    got = _read(monkeypatch, DETECT, "bias_leaky_ms.detect", {"segment_calls": 1}, snap)
    assert got == pytest.approx(1.5)
