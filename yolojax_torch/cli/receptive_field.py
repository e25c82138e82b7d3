"""``receptive_field`` command of the port: effective receptive field probe
(counterpart of ``yolojax/cli/receptive_field.py``).

Backpropagates ``|raw|`` summed over one output cell's channels to a
0.5-filled image through the unfolded eval-mode forward
(``model.apply(..., train=False)``, ``engine.run_plan(..., state=)``), with
autograd where the reference takes ``jax.grad``, and measures the input
gradient's support and spread.

    python -m yolojax_torch.cli.receptive_field -c config.ini [--size 416] [--device cuda] [-o map.png]
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import make_parser, setup
from .common import build

__all__ = ["receptive_field", "main"]

_LOG = logging.getLogger(__name__)


def receptive_field(model, params, state, size: int, cell=None):
    """(gradient map (S, S), support box (ymin, xmin, ymax, xmax) or None,
    effective RF) for one output cell (the centre one by default), on the
    params' device."""
    device = next(iter(params.values()))["w"].device
    x = torch.full((1, size, size, 3), 0.5, dtype=torch.float32, device=device,
                   requires_grad=True)
    raw, _ = model.apply(params, state, x, train=False)
    h, w = raw.shape[1], raw.shape[2]
    cy, cx = cell if cell is not None else (h // 2, w // 2)
    raw[0, cy, cx, :].abs().sum().backward()
    g = x.grad.abs()[0].sum(-1).cpu().numpy()  # (S, S)
    ys, xs = np.nonzero(g > 0)
    support = (int(ys.min()), int(xs.min()), int(ys.max()), int(xs.max())) if len(ys) else None
    # effective RF: std of the gradient-mass distribution
    total = g.sum()
    if total > 0:
        yy, xx = np.mgrid[0:size, 0:size]
        cy = (g * yy).sum() / total
        cx = (g * xx).sum() / total
        eff = 2 * np.sqrt(((g * ((yy - cy) ** 2 + (xx - cx) ** 2)).sum() / total) / 2)
    else:
        eff = 0.0
    return g, support, float(eff)


def main(argv=None):
    parser = make_parser("probe the theoretical + effective receptive field")
    parser.add_argument("--size", type=int, default=416)
    parser.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    parser.add_argument("-o", "--output", default=None, help="heatmap png path")
    args = parser.parse_args(argv)
    config = setup(args)

    category, anchors, model = build(config)
    params, state = model.init(torch.Generator().manual_seed(0), args.device)
    g, support, eff = receptive_field(model, params, state, args.size)
    if support:
        h = support[2] - support[0] + 1
        w = support[3] - support[1] + 1
        _LOG.info("gradient support %dx%d px, effective RF ≈ %.1f px", h, w, eff)
        print(f"support={h}x{w} effective={eff:.1f}")
    if args.output:
        from PIL import Image

        img = (g / max(g.max(), 1e-12) * 255).astype(np.uint8)
        Image.fromarray(img).save(args.output)
        _LOG.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
