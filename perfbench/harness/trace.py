"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` over a few
timed calls, read back from its Chrome trace into a plain record that the
per-layer metrics (``metrics/<name>.py``) read.

The record holds, for the span ``perfbench.window`` (from a synchronize
before the first traced call to one after the last):

* ``window_s``: its length; ``busy_s``: the union of every device
  activity (kernels, copies, fills) inside it;
* ``kernels``: ``[name, seconds]`` of every device activity inside it;
* ``launches``: the host's kernel-launch calls in it (``cudaLaunchKernel``,
  ``cuLaunchKernel`` and their ``Ex`` forms), and ``launched``: how many of
  those calls have a device activity of the same correlation id in the
  trace, so that a reader can tell whether the profiler dropped events;
* ``idle_gaps``: the device's idle time inside it, summed by the innermost
  host event running at the middle of each gap;
* ``device_ops``: device time summed by name.

The trace file is written under the temporary directory and removed."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

__all__ = ["Segment", "read_trace", "LAUNCH_CALLS"]

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "perfbench.window"


class Segment:
    """``with Segment() as seg: ...`` profiles the block between two
    synchronizes under the span ``perfbench.window``; ``seg.record`` holds
    the reading afterwards and ``seg.seconds`` the host's length of it."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._span = record_function(WINDOW)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.record = read_trace(json.load(f))
            finally:
                with contextlib.suppress(FileNotFoundError):
                    os.remove(path)
        return False


def _union(intervals):
    total, end = 0.0, -float("inf")
    merged = []
    for s, e in sorted(intervals):
        if s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def read_trace(trace: dict) -> dict:
    """The record (module docstring) of a Chrome trace that holds one
    ``perfbench.window`` span."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not spans:
        raise RuntimeError("trace: no perfbench.window span in the profiler's trace")
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    inside = lambda e: float(e["ts"]) >= w0 and float(e["ts"]) < w1
    device = [e for e in events if e.get("cat") in DEVICE_CATS and inside(e)]
    host = [e for e in events if e.get("cat") in HOST_CATS and inside(e) and e["name"] != WINDOW]
    clip = lambda e: (float(e["ts"]), min(float(e["ts"]) + float(e.get("dur", 0)), w1))
    busy_us, merged = _union(clip(e) for e in device)
    ops: dict = {}
    for e in device:
        ops[e["name"]] = ops.get(e["name"], 0.0) + float(e.get("dur", 0)) / 1e6
    correlated = {e.get("args", {}).get("correlation") for e in device}
    launch_events = [e for e in host if e["name"] in LAUNCH_CALLS]
    launched = sum(1 for e in launch_events
                   if e.get("args", {}).get("correlation") in correlated)
    # idle gaps inside the window, each named by the innermost host event
    # running at its middle
    edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
    holes = sorted(((s + e) / 2, e - s) for s, e in zip(edges[0::2], edges[1::2]) if e > s)
    host_iv = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"])
                     for e in host)
    gaps, active, j = {}, [], 0
    for mid, length in holes:          # a sweep: both lists in time order
        while j < len(host_iv) and host_iv[j][0] <= mid:
            active.append(host_iv[j])
            j += 1
        active = [h for h in active if h[1] > mid]
        name = min(active, key=lambda h: h[1] - h[0])[2] if active else WINDOW
        gaps[name] = gaps.get(name, 0.0) + length / 1e6
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "kernels": [[e["name"], float(e.get("dur", 0)) / 1e6] for e in device
                        if e.get("cat") == "kernel"],
            "launches": len(launch_events), "launched": launched,
            "device_ops": top(ops), "idle_gaps": top(gaps)}
