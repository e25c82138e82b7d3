"""dwconv_roofline.detect: the depthwise 3x3 kernel (csrc/dwconv3x3.cu) over the
dwconv-routed layers of a
detect call, as a share of its roofline, in %: the least time (the larger of
the layers' FLOPs over 989 TFLOP/s and their bytes, each input read once and
each output written once, over 3.35 TB/s; harness/shapes.py) over the
kernel's device time in the traced segment.  Read only where the segment's
events of the kernel are as many as the port counted launches, and those as
many as the routed layers ask; moves detect_img_per_s."""

from perfbench.harness.kernels import device_seconds
from perfbench.harness.peaks import least_seconds

KERNEL = "dwconv"
PATTERN = r"dwconv3x3"


def read(record):
    if not record or not record.get("routed", {}).get(KERNEL):
        return None
    seconds, count = device_seconds(record, PATTERN, exclude_own=False)
    launches = record["counters"][KERNEL]
    expected = record["routed"][KERNEL] * record["segment_calls"]
    if not seconds or count != launches or launches != expected:
        return None
    flops, bytes_ = record["kernel_work"][KERNEL]
    return 100.0 * least_seconds(flops, bytes_) * record["segment_calls"] / seconds
