"""``export`` command of the port: serialize the inference graph
(counterpart of ``yolojax/cli/export.py``).

``--format pt2`` (the default) takes the place of the reference's
StableHLO: ``torch.export.export`` of the folded forward and the decode
(``ops/decode.py::decode_flat``: one packed ``(B, N, 5+C)`` output
``[ymin, xmin, ymax, xmax, iou, conf...]``) on a ``(batch, size, size, 3)``
f32 NHWC input, saved with ``torch.export.save`` to
``<model dir>/inference_{size}.pt2``.  Where the config routes forward
kernels (``[model] pallas``: dwsep, dwconv, pool, reorg), the program calls
them as the custom ops of ``kernels/ops.py``, so loading it needs that
module imported first::

    import torch, yolojax_torch.kernels.ops
    program = torch.export.load("inference_416.pt2")
    packed = program.module()(images)

``--format onnx`` writes an ONNX ModelProto through the self-contained
protobuf writer of ``tools/onnx_export.py`` (NCHW input, f32 weights).

    python -m yolojax_torch.cli.export -c config.ini [-f CKPT] [--size 416]
        [--batch 1] [--format pt2|onnx] [--device cuda] [-o PATH]
"""

from __future__ import annotations

import logging
import os

import torch

from .. import config as _config
from ..models.inference import Inference
from ..ops.decode import decode_flat
from . import make_parser, setup
from .common import build, load_weights_auto

__all__ = ["Packed", "export_program", "main"]

_LOG = logging.getLogger(__name__)


class Packed(torch.nn.Module):
    """The folded forward + ``decode_flat`` as a module: the folded weights
    (each layer's ``w``, ``b`` and the kernels' layouts) and the anchors are
    its buffers, so the exported program carries them."""

    def __init__(self, model, folded: dict, anchors: torch.Tensor):
        super().__init__()
        self.model = model
        self.leaves = {layer: tuple(leaves) for layer, leaves in folded.items()}
        for layer, leaves in folded.items():
            for name, t in leaves.items():
                self.register_buffer(f"{layer}__{name}", t)
        self.register_buffer("anchors", anchors)

    def forward(self, images):
        folded = {layer: {name: getattr(self, f"{layer}__{name}") for name in names}
                  for layer, names in self.leaves.items()}
        return decode_flat(self.model.apply_folded(folded, images), self.anchors)


def export_program(model, folded: dict, anchors, size: int, batch: int = 1):
    """``torch.export.export`` of :class:`Packed` on a (batch, size, size, 3)
    f32 input on the folded weights' device."""
    device = next(iter(folded.values()))["w"].device
    module = Packed(model, folded, torch.as_tensor(anchors, dtype=torch.float32, device=device))
    example = torch.zeros((batch, size, size, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        return torch.export.export(module, (example,))


def main(argv=None):
    parser = make_parser("export forward+decode as a torch.export program (or ONNX)")
    parser.add_argument("-f", "--file", default=None,
                        help="checkpoint or .weights (default: latest)")
    parser.add_argument("--size", type=int, default=416)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("-o", "--output", default=None, help="output .pt2 / .onnx path")
    parser.add_argument("--format", choices=["pt2", "onnx"], default="pt2")
    parser.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    args = parser.parse_args(argv)
    config = setup(args)

    category, anchors, model = build(config)
    params, state, _ = load_weights_auto(config, model, args.file, resume=args.file is None,
                                         device=args.device)
    folded = Inference(model).fold(params, state)
    out = args.output
    if out is None:
        model_dir = _config.get_model_dir(config)
        os.makedirs(model_dir, exist_ok=True)
        out = os.path.join(model_dir, f"inference_{args.size}.{args.format}")

    if args.format == "onnx":
        from ..tools.onnx_export import export_onnx

        blob = export_onnx(model, folded, anchors, args.size, batch=args.batch)
        with open(out, "wb") as f:
            f.write(blob)
        _LOG.info("exported ONNX %d bytes (NCHW input %s)", len(blob),
                  (args.batch, 3, args.size, args.size))
        print(out)
        return 0

    program = export_program(model, folded, anchors, args.size, args.batch)
    torch.export.save(program, out)
    _LOG.info("exported %s (in: %s on %s)", out, (args.batch, args.size, args.size, 3),
              args.device)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
