"""bias_leaky_ms.detect: device ms a detect call in the backbone's f32 bias +
leaky epilogue (models/blocks.py::bias_leaky), read from the program's
yolojax_torch.plan.epilogue spans over the traced segment (harness/spans.py);
moves detect_img_per_s."""

from perfbench.harness.spans import device_ms_per_call


def read(record):
    return device_ms_per_call(record, "yolojax_torch.plan.epilogue")
