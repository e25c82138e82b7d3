"""host_optimizer_ms.train: host ms of a train step's optimizer phase
(Optimizer.step's clip, decay and momentum over every leaf, and the metrics'
global norm), the median over the traced segment's steps of the program's
yolojax_torch.train.optimizer spans (harness/spans.py); moves
train_img_per_s."""

from perfbench.harness.spans import host_ms_median


def read(record):
    return host_ms_median(record, "yolojax_torch.train.optimizer")
