"""One kernel call's time and bound, for the tools that time the decode+NMS
kernels (``gate_fused_times``, ``c80_fusedpost``).

The bound of a call is the larger of the bytes it must move (each input
read once, each output written once) over 3.35 TB/s and its float32
operations over 67 TFLOP/s, an H100 SXM's HBM3 rate and float32 peak.  A
YOLOv2 head's decode costs ~3 operations per class score and 20 per
candidate, and each greedy pick an argmax and an IoU, ~16 per candidate
(:func:`decode_nms_ops`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def event_ms(fn, reps: int, warmup: int = 3) -> list[float]:
    """``reps`` calls of ``fn`` after ``warmup`` ones, each between two CUDA
    events (ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def one_call_ms(fn, device: torch.device, reps: int, warmup: int = 3) -> float:
    """The median of :func:`event_ms` on a card; of the host clock around a
    call on the CPU."""
    if device.type == "cuda":
        return float(np.median(event_ms(fn, reps, warmup)))
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_us(fn, kernel: str, calls: int) -> tuple[float, str]:
    """The device time of one call of ``kernel``: the median of its events
    that ``torch.profiler`` recorded over ``calls`` calls, or, where it
    recorded none (it drops device events on some machines), CUDA events
    around one more call.  Returns (µs, how it was read)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and kernel in e.name]
    if times:
        return float(np.median(times)), f"profiler, median of {len(times)} of {calls} calls"
    return event_ms(fn, reps=1, warmup=0)[0] * 1e3, \
        "CUDA events around one call: the profiler recorded none"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def decode_nms_ops(candidates: int, picks: int, images: int = 0, classes: int = 0) -> int:
    """Float32 operations of ``picks`` greedy picks over rows of
    ``candidates``, after the decode of ``images`` heads of ``classes``
    classes (none: the NMS alone, on a decoded head)."""
    return images * candidates * (3 * classes + 20) + picks * candidates * 16


def bound(moved: int, f32_ops: int) -> dict:
    """{"bound_ms", "bound_by"}: the larger of ``moved`` bytes over
    PEAK_BYTES and ``f32_ops`` over PEAK_F32."""
    by_bytes, by_ops = moved / PEAK_BYTES * 1e3, f32_ops / PEAK_F32 * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}
