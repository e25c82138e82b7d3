"""``prune`` command of the port: slim a trained checkpoint by BN-γ ranking
(counterpart of ``yolojax/cli/prune.py``).

Writes ``<out>/channels.json`` (the pruned widths) and ``<out>/<step>.npz``
(the slimmed params and state in the checkpoint format either package
loads, ``meta["channels"]`` beside the step); the pruned model is rebuilt
with ``-m model/channels=<out>/channels.json``.  The ranking and slicing are
host work on the loaded arrays, so the command runs on the CPU.

    python -m yolojax_torch.cli.prune -c config.ini [-f CKPT] [--ratio 0.3] [-o DIR]
"""

from __future__ import annotations

import logging
import os

from .. import config as _config
from ..tools.prune import prune, save_channels
from ..utils import checkpoint as ckpt
from . import make_parser, setup
from .common import build, load_weights_auto

_LOG = logging.getLogger(__name__)


def main(argv=None):
    parser = make_parser("prune channels by BatchNorm gamma magnitude")
    parser.add_argument("-f", "--file", default=None,
                        help="checkpoint to prune (default: latest)")
    parser.add_argument("--ratio", type=float, default=0.3,
                        help="fraction of prunable channels to REMOVE")
    parser.add_argument("-o", "--output", default=None,
                        help="output dir (default: <model_dir>/pruned)")
    args = parser.parse_args(argv)
    config = setup(args)

    category, anchors, model = build(config)
    params, state, meta = load_weights_auto(config, model, args.file, resume=args.file is None)
    new_params, new_state, channels = prune(model, params, state, args.ratio)

    out_dir = args.output or os.path.join(_config.get_model_dir(config), "pruned")
    os.makedirs(out_dir, exist_ok=True)
    channels_path = os.path.join(out_dir, "channels.json")
    save_channels(channels_path, channels)
    jparams, jstate = ckpt.to_jax(new_params, new_state)
    step = int(meta.get("step", 0))
    ckpt.save(os.path.join(out_dir, f"{step}.npz"), {"params": jparams, "state": jstate},
              {"step": step, "seen": int(meta.get("seen", 0)), "channels": channels})
    kept = sum(channels.values())
    _LOG.info("pruned %d layers → %s; rerun with -m model/channels=%s",
              len(channels), out_dir, channels_path)
    print(f"wrote {out_dir} ({kept} surviving channels across {len(channels)} layers)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
