"""epilogue_ms.detect: device ms a detect call in PyTorch's elementwise
kernels (the backbone's f32 bias + leaky epilogue, its casts, the copies of
the reorg and the concat), over the traced segment; moves detect_img_per_s."""

from perfbench.harness.kernels import device_seconds, events_complete

PATTERN = r"elementwise_kernel|vectorized_elementwise|unrolled_elementwise"


def read(record):
    if not record or not events_complete(record):
        return None
    seconds, count = device_seconds(record, PATTERN)
    return seconds * 1e3 / record["segment_calls"] if count else None
