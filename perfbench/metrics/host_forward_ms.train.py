"""host_forward_ms.train: host ms of a train step's forward phase (the unfolded
train-mode forward), the median over the traced segment's steps of the
program's yolojax_torch.train.forward spans (harness/spans.py); moves
train_img_per_s."""

from perfbench.harness.spans import host_ms_median


def read(record):
    return host_ms_median(record, "yolojax_torch.train.forward")
