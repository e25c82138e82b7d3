"""host_post_ms.stream: host ms of a camera-stream detect call's post step
(the fused decode + NMS kernel's wrapper), the median over the traced
segment's calls of the program's yolojax_torch.post spans
(harness/spans.py); moves stream_p95_ms."""

from perfbench.harness.spans import host_ms_median


def read(record):
    return host_ms_median(record, "yolojax_torch.post")
