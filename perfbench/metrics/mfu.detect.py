"""mfu.detect: the whole detect step's share of the card's bf16 peak, in %:
the folded forward's conv FLOPs (2 x MACs from the layer shapes) times the
images of the window over the window's time, the same window and calls as
detect_img_per_s; moves detect_img_per_s."""

from perfbench.harness.peaks import BF16_FLOPS


def read(record):
    if not record or not record["window_s"]:
        return None
    images_per_s = record["window_images"] / record["window_s"]
    return 100.0 * record["forward_flops"] * images_per_s / BF16_FLOPS
