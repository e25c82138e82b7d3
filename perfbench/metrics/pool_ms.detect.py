"""pool_ms.detect: device ms a detect call in the backbone's max pools
(blocks.max_pool, or the pool kernel with the epilogue it takes), read from
the program's yolojax_torch.plan.pool spans over the traced segment
(harness/spans.py); moves detect_img_per_s."""

from perfbench.harness.spans import device_ms_per_call


def read(record):
    return device_ms_per_call(record, "yolojax_torch.plan.pool")
