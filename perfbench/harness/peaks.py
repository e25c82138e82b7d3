"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W): the yardstick of the rooflines and of ``mfu``."""

BF16_FLOPS = 989e12        # bf16 tensor-core FLOP/s
HBM_BYTES = 3.35e12        # HBM3 bytes/s


def least_seconds(flops: float, bytes_: float) -> float:
    """The least time the chip could take for the work: the larger of its
    operations over the bf16 peak and its bytes over the memory's."""
    return max(flops / BF16_FLOPS, bytes_ / HBM_BYTES)
