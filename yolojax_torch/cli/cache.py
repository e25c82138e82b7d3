"""``cache`` command of the port: build the dataset record caches
(counterpart of ``yolojax/cli/cache.py``).

    python -m yolojax_torch.cli.cache -c config.ini [more.ini …] [-p train test]
"""

from __future__ import annotations

import logging

from ..data.cache import PHASES, cache
from . import make_parser, setup

_LOG = logging.getLogger(__name__)


def main(argv=None):
    parser = make_parser("build dataset caches (VOC/COCO → numpy record pickles)")
    parser.add_argument("-p", "--phase", nargs="+", default=list(PHASES),
                        choices=list(PHASES))
    args = parser.parse_args(argv)
    config = setup(args)
    out = cache(config, phases=tuple(args.phase))
    for phase, records in out.items():
        boxes = sum(len(r["cls"]) for r in records)
        _LOG.info("%s: %d images, %d boxes", phase, len(records), boxes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
