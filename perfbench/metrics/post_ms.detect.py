"""post_ms.detect: device ms a detect call in the post step after the
forward (the fused decode + NMS kernel, csrc/postprocess_fused.cu, on the
configurations' route), read from the program's yolojax_torch.post spans over
the traced segment (harness/spans.py); moves detect_img_per_s."""

from perfbench.harness.spans import device_ms_per_call


def read(record):
    return device_ms_per_call(record, "yolojax_torch.post")
