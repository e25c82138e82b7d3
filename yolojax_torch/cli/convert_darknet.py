"""``convert_darknet`` command of the port: darknet ``.weights`` ↔ npz
checkpoints (counterpart of ``yolojax/cli/convert_darknet.py``).

    python -m yolojax_torch.cli.convert_darknet FILE.weights -c config.ini [-o OUT.npz]
    python -m yolojax_torch.cli.convert_darknet CKPT.npz -c config.ini --reverse [-o OUT.weights]

Import writes an npz checkpoint (step 0, the file's ``seen``) in the model
dir, ready for ``train -r``, ``eval`` and ``detect`` of either package.
``--reverse`` writes a checkpoint back to darknet format.
"""

from __future__ import annotations

import logging
import os

from .. import config as _config
from ..tools.darknet import load_weights, save_weights
from ..utils import checkpoint as ckpt
from . import make_parser, setup
from .common import build, load_weights_auto

_LOG = logging.getLogger(__name__)


def main(argv=None):
    parser = make_parser("convert darknet .weights to a yolojax checkpoint (or back)")
    parser.add_argument("file", help=".weights to import (or checkpoint with --reverse)")
    parser.add_argument("-o", "--output", default=None)
    parser.add_argument("--reverse", action="store_true",
                        help="checkpoint .npz → darknet .weights")
    args = parser.parse_args(argv)
    config = setup(args)
    category, anchors, model = build(config)

    if args.reverse:
        params, state, meta = load_weights_auto(config, model, args.file)
        out = args.output or os.path.splitext(args.file)[0] + ".weights"
        save_weights(out, model, params, state, seen=int(meta.get("seen", 0)))
        _LOG.info("wrote %s", out)
    else:
        params, state, seen = load_weights(args.file, model)
        out = args.output
        if out is None:
            model_dir = _config.get_model_dir(config)
            os.makedirs(model_dir, exist_ok=True)
            out = os.path.join(model_dir, "0.npz")
        jparams, jstate = ckpt.to_jax(params, state)
        ckpt.save(out, {"params": jparams, "state": jstate}, {"step": 0, "seen": seen})
        _LOG.info("imported %s → %s (seen=%d)", args.file, out, seen)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
