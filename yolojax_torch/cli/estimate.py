"""``estimate`` command of the port: k-means anchor clustering over the train
cache (counterpart of ``yolojax/cli/estimate.py``).

    python -m yolojax_torch.cli.estimate -c config.ini [more.ini …] -k 5 [-o anchors.tsv]
"""

from __future__ import annotations

import logging

from ..data.cache import load_cache
from ..tools.kmeans import collect_hw, kmeans_anchors
from . import make_parser, setup

_LOG = logging.getLogger(__name__)


def main(argv=None):
    parser = make_parser("estimate anchors by IoU k-means over cached gt boxes")
    parser.add_argument("-k", "--num", type=int, default=5, help="number of anchors")
    parser.add_argument("--size", type=int, default=416, help="reference input size")
    parser.add_argument("--stride", type=int, default=32)
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("-o", "--output", default=None, help="anchors tsv path")
    args = parser.parse_args(argv)
    config = setup(args)

    records = load_cache(config, "train")
    hw = collect_hw(records, grid=args.size / args.stride)
    anchors, mean_iou = kmeans_anchors(hw, args.num, iters=args.iters, seed=args.seed)
    _LOG.info("%d boxes → %d anchors, mean best IoU %.4f", len(hw), args.num, mean_iou)
    lines = "\n".join(f"{h:.5f}\t{w:.5f}" for h, w in anchors)
    print(lines)
    if args.output:
        with open(args.output, "w") as f:
            f.write(lines + "\n")
        _LOG.info("wrote %s (point [model] anchors at it)", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
