"""The port's tracer: named spans at the layer boundaries of a detect call
(``models/inference.py``), the folded plan walk (``models/engine.py``) and
a train step (``parallel/mesh.py``), recorded only while a
``torch.profiler`` is recording.

    with span("yolojax_torch.plan.conv", layer="c1"):
        y = conv(x, w)

With no profiler recording, ``span`` reads one flag and returns a shared
no-op context: no ``record_function``, no CUDA event, no record.  Nor does
it record while ``torch.export`` or ``torch.compile`` traces, so no
profiler op enters a traced graph.  While a profiler records, a span

* enters ``torch.profiler.record_function(name)``, so it shows in the
  profiler's Chrome trace as a ``user_annotation`` on the clock of the
  device's events;
* takes ``time.perf_counter_ns()`` at both ends;
* where its work is on CUDA, records a timing ``torch.cuda.Event`` at both
  ends, on the stream that was current when its root span began.  A root
  span says so (``cuda=True``); its children inherit it;
* is kept in this process's list (at most ``MAX_SPANS``; the rest are
  counted as ``dropped``) with its id, its parent's and its root's: the
  spans of one call or step share their root's id.

:func:`snapshot` reads the list back, with each span's host ms and, after a
synchronize, its device ms (the time between its two events on the
stream), beside the kernel wrappers' own launch counters; :func:`reset`
empties it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "snapshot", "reset", "MAX_SPANS"]

MAX_SPANS = 200_000

_spans: list[tuple] = []     # (id, parent, root, name, t0_ns, t1_ns, events, attrs)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()   # .stack: this thread's open spans


_OFF = contextlib.nullcontext()   # the context of a span that records nothing


class _Span:
    __slots__ = ("name", "attrs", "cuda", "id", "parent", "root", "scope", "stream", "e0", "t0")

    def __init__(self, name: str, cuda, attrs: dict):
        self.name, self.cuda, self.attrs = name, cuda, attrs

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.root = up.root if up else self.id
        if self.cuda is None:
            self.cuda = up.cuda if up else False
        self.scope = torch.profiler.record_function(self.name)
        self.scope.__enter__()
        self.e0 = None
        if self.cuda:
            # a call or step runs on one stream, so the root alone looks it up:
            # a lookup makes CUDA runtime calls, which the profiler traces
            self.stream = up.stream if up and up.cuda else torch.cuda.current_stream()
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record(self.stream)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        events = None
        if self.e0 is not None:
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record(self.stream)
            events = (self.e0, e1)
        self.scope.__exit__(*exc)
        _local.stack.pop()
        _keep((self.id, self.parent, self.root, self.name, self.t0, t1, events, self.attrs))
        return False


def _keep(record: tuple) -> None:
    global _dropped
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(record)
        else:
            _dropped += 1


def span(name: str, cuda: bool | None = None, **attrs):
    """A context that records the span ``name`` with ``attrs`` while a
    ``torch.profiler`` records, and does nothing otherwise.  ``cuda``: the
    span's work is on CUDA (then it records device events); None takes the
    enclosing span's, and no enclosing span means False."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if torch.compiler.is_compiling():
        return _OFF
    return _Span(name, cuda, attrs)


def snapshot() -> dict:
    """Every kept span, in the order they ended, as ``{id, parent, root,
    name, t0_ns, t1_ns, host_ms, device_ms, attrs}`` (``device_ms`` None
    where the span recorded no events), with ``dropped`` and ``counters``:
    the launches each hand-written kernel's wrapper has counted."""
    with _lock:
        kept, dropped = list(_spans), _dropped
    if any(r[6] is not None for r in kept):
        torch.cuda.synchronize()
    spans = [{"id": i, "parent": parent, "root": root, "name": name, "t0_ns": t0,
              "t1_ns": t1, "host_ms": (t1 - t0) / 1e6,
              "device_ms": None if events is None else events[0].elapsed_time(events[1]),
              "attrs": attrs}
             for i, parent, root, name, t0, t1, events, attrs in kept]
    return {"spans": spans, "dropped": dropped, "counters": _launch_counters()}


def reset() -> None:
    """Forget every kept span and the dropped count."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def _launch_counters() -> dict:
    from ..kernels.dwconv import dwconv3x3
    from ..kernels.dwsep import dwsep
    from ..kernels.epilogue import bias_leaky_nhwc
    from ..kernels.nms import nms_select
    from ..kernels.pool import maxpool2x2
    from ..kernels.postprocess_fused import postprocess_fused
    from ..kernels.reorg import reorg_s2d

    return {f.__name__: f.launches for f in (dwconv3x3, dwsep, maxpool2x2, reorg_s2d,
                                             bias_leaky_nhwc, postprocess_fused, nms_select)}
