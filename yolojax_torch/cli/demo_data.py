"""``demo_data`` command of the port: visualize augmented training samples
(counterpart of ``yolojax/cli/demo_data.py``; the check that image and
boxes transform together).

The train cache → ``Dataset`` → ``Loader`` (one shuffled batch) →
``TrainAugment`` with its draws from ``torch.Generator().manual_seed(seed)``
on ``--device`` → ``draw_boxes`` → one PNG per sample.  :func:`samples`
stops before the drawing, which needs PIL, and the PNG, which needs PIL
too: it returns the augmented images and their boxes.

    python -m yolojax_torch.cli.demo_data -c config.ini [-n 8] [--size 416] [-o DIR]
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..category import get_category
from ..config import get_canvas
from ..data.cache import load_cache
from ..data.dataset import Dataset, _imread_rgb
from ..data.loader import Loader
from ..data.transform import TrainAugment
from ..utils.visualize import draw_boxes
from . import make_parser, setup

__all__ = ["samples", "main"]

_LOG = logging.getLogger(__name__)

BOX_KEYS = ("canvas", "hw", "yx_min", "yx_max", "valid")


def samples(config, num: int, size: int, seed: int = 0, device="cuda", imread=_imread_rgb):
    """One augmented batch of the train cache: (images (B, S, S, 3) f32 numpy
    in [0, 1], [(yx_min, yx_max, cls) of the valid boxes] per image), B =
    min(num, records)."""
    records = load_cache(config, "train")
    dataset = Dataset(records, canvas=get_canvas(config),
                      max_boxes=config.getint("data", "max_boxes", fallback=60), imread=imread)
    loader = Loader(dataset, batch_size=min(num, len(dataset)), seed=seed)
    augment = TrainAugment.from_config(config)
    batch = next(iter(loader.epoch()))
    draws = augment.draw(torch.Generator().manual_seed(seed), len(batch["canvas"]))
    t = [torch.from_numpy(np.ascontiguousarray(batch[k])).to(device) for k in BOX_KEYS]
    images, bmin, bmax, bvalid = augment.apply(*t, draws, size)
    images = images.float().cpu().numpy()
    bmin, bmax, bvalid = bmin.cpu().numpy(), bmax.cpu().numpy(), bvalid.cpu().numpy()
    boxes = [(bmin[b][v], bmax[b][v], np.asarray(batch["cls"][b])[v])
             for b, v in enumerate(bvalid)]
    return images, boxes


def main(argv=None):
    parser = make_parser("visualize augmented training batches with gt boxes")
    parser.add_argument("-n", "--num", type=int, default=8, help="images to dump")
    parser.add_argument("--size", type=int, default=416)
    parser.add_argument("-o", "--output", default="demo_data_out")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    args = parser.parse_args(argv)
    config = setup(args)

    category = get_category(config)
    images, boxes = samples(config, args.num, args.size, args.seed, args.device)
    os.makedirs(args.output, exist_ok=True)
    from PIL import Image

    for b, (image, (ymin, ymax, cls)) in enumerate(zip(images, boxes)):
        path = os.path.join(args.output, f"sample{b}.png")
        Image.fromarray(draw_boxes(image, ymin, ymax, cls, category=category)).save(path)
        _LOG.info("wrote %s (%d boxes)", path, len(cls))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
