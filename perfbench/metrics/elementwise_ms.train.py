"""elementwise_ms.train: device ms a train step in PyTorch's elementwise
and reduction kernels (BN's statistics and passes, leaky, the loss, the
optimizer's per-leaf updates), over the traced segment; moves
train_img_per_s."""

from perfbench.harness.kernels import device_seconds, events_complete

PATTERN = r"elementwise|reduce_kernel|[Rr]eduction|Welford"


def read(record):
    if not record or not events_complete(record):
        return None
    seconds, count = device_seconds(record, PATTERN)
    return seconds * 1e3 / record["segment_steps"] if count else None
