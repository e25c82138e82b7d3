"""Reading device time by kernel name from a traced segment's record
(``trace.py``), for the per-layer metrics."""

from __future__ import annotations

import re

__all__ = ["device_seconds", "events_complete", "OWN_KERNELS"]

# the port's hand-written kernels (yolojax_torch/csrc), never counted as a
# library's convolution or elementwise kernel
OWN_KERNELS = re.compile(r"dwconv3x3|dwsep|postprocess_fused|maxpool2x2|reorg_s2d|nms_select")


def device_seconds(record: dict, pattern: str, exclude_own: bool = True) -> tuple[float, int]:
    """(seconds, events) of the segment's kernels whose names match
    ``pattern``."""
    rx = re.compile(pattern)
    total, count = 0.0, 0
    for name, seconds in record["segment"]["kernels"]:
        if rx.search(name) and not (exclude_own and OWN_KERNELS.search(name)):
            total += seconds
            count += 1
    return total, count


def events_complete(record: dict) -> bool:
    """Whether every kernel launch of the segment has its device event: the
    profiler drops device events on some machines, and a device time read
    from such a trace would be short."""
    seg = record.get("segment") or {}
    return seg.get("launches", 0) > 0 and seg.get("launched") == seg.get("launches")
