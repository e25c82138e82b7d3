"""conv_ms.detect: device ms a detect call in the library convolution
kernels (cuDNN, its xmma and implicit-GEMM kernels, CUTLASS), over the
traced segment; moves detect_img_per_s."""

from perfbench.harness.kernels import device_seconds, events_complete

PATTERN = r"xmma|implicit_gemm|cudnn|cutlass|gemm|convolve|conv2d|fprop|winograd|sm90_|sm80_"


def read(record):
    if not record or not events_complete(record):
        return None
    seconds, count = device_seconds(record, PATTERN)
    return seconds * 1e3 / record["segment_calls"] if count else None
