"""The program's own spans (``yolojax_torch/utils/trace.py``) over a traced
segment, for the per-layer metrics that read them.

The port keeps a span only while a profiler records, and a run records only
in its traced segment (``trace.py::Segment``), so the tracer's snapshot,
taken once the segment has ended, holds the segment's spans alone.  It
matches the segment where its root spans are as many as the segment's calls
(``segment_calls``, a detect cell), at least as many as its counted calls
(``segment_batches``, a stream cell: the lead-in's calls are traced too), or
as many as its steps (``segment_steps``, a train cell), and it dropped
none.  A span's device time is the time between its two events on the
stream, which is its kernels' time only where the queue before them is never
empty: read it on the detect cells alone.

Each reader gives None where the program has no tracer (a checkout from
before it), or where the snapshot does not match the segment."""

from __future__ import annotations

import statistics

__all__ = ["snapshot", "calls", "device_ms_per_call", "host_ms_median"]

DETECT = "yolojax_torch.detect"
STEP = "yolojax_torch.train_step"


def snapshot() -> dict | None:
    """The program's tracer's snapshot, or None where it has no tracer."""
    try:
        from yolojax_torch.utils.trace import snapshot as take
    except ImportError:
        return None
    return take()


def calls(record) -> list[list[dict]] | None:
    """The segment's spans, one list a call or step (all the spans of one
    root), or None where the snapshot does not match the segment."""
    if not record:
        return None
    if "segment_steps" in record:
        root, matches = STEP, lambda n: n == record["segment_steps"]
    elif "segment_calls" in record:
        root, matches = DETECT, lambda n: n == record["segment_calls"]
    elif "segment_batches" in record:
        root, matches = DETECT, lambda n: n >= len(record["segment_batches"])
    else:
        return None
    snap = snapshot()
    if snap is None or snap["dropped"]:
        return None
    by_root = {s["id"]: [] for s in snap["spans"] if s["name"] == root and s["parent"] is None}
    if not by_root or not matches(len(by_root)):
        return None
    for s in snap["spans"]:
        if s["root"] in by_root:
            by_root[s["root"]].append(s)
    return list(by_root.values())


def device_ms_per_call(record, name: str) -> float | None:
    """The device ms of every span ``name`` in the segment over its calls."""
    segment = calls(record)
    if segment is None:
        return None
    times = [s["device_ms"] for call in segment for s in call if s["name"] == name]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / len(segment)


def host_ms_median(record, name: str) -> float | None:
    """The median over the segment's calls or steps of the host ms of the
    spans ``name`` in each (over those that ran it)."""
    segment = calls(record)
    if segment is None:
        return None
    per = [sum(s["host_ms"] for s in call if s["name"] == name) for call in segment
           if any(s["name"] == name for s in call)]
    return statistics.median(per) if per else None
