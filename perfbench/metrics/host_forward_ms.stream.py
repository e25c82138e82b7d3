"""host_forward_ms.stream: host ms of a camera-stream detect call's forward
(the folded plan walk's issue), the median over the traced segment's calls
of the program's yolojax_torch.forward spans (harness/spans.py); moves
stream_p95_ms."""

from perfbench.harness.spans import host_ms_median


def read(record):
    return host_ms_median(record, "yolojax_torch.forward")
