"""host_loss_ms.train: host ms of a train step's loss phase (the region loss
and its weighted total), the median over the traced segment's steps of the
program's yolojax_torch.train.loss spans (harness/spans.py); moves
train_img_per_s."""

from perfbench.harness.spans import host_ms_median


def read(record):
    return host_ms_median(record, "yolojax_torch.train.loss")
