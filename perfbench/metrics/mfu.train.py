"""mfu.train: the whole train step's share of the card's bf16 peak, in %: three
times the forward's conv FLOPs (forward, and the two products of the
backward) times the images of the window over the window's time, the same
window and steps as train_img_per_s; moves train_img_per_s."""

from perfbench.harness.peaks import BF16_FLOPS


def read(record):
    if not record or not record["window_s"]:
        return None
    images_per_s = record["window_images"] / record["window_s"]
    return 300.0 * record["forward_flops"] * images_per_s / BF16_FLOPS
