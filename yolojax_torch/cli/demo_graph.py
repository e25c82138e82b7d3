"""``demo_graph`` command of the port: computation-graph inspection
(counterpart of ``yolojax/cli/demo_graph.py``).

Writes, under ``-o``:

* ``plan.dot`` — the model *plan* (the explicit layer graph that drives
  init, forward and weight import) as graphviz text, the reference's
  :func:`plan_to_dot` letter for letter, and ``plan.png`` where the
  ``graphviz`` package and binary are installed;
* ``model.graph.txt`` — the ``torch.export`` program of the folded forward
  and decode (``cli/export.py::export_program``), the counterpart of the
  reference's jaxpr: every aten op, with the forward kernels the config
  routes as ``yolojax_torch.*`` custom-op calls;
* ``model.fx.py`` — the same program as ``torch.fx`` Python code, the
  counterpart of the reference's optimized HLO.

    python -m yolojax_torch.cli.demo_graph -c config.ini [--size 416] [--device cuda] [-o DIR]
"""

from __future__ import annotations

import logging
import os

import torch

from . import make_parser, setup
from .common import build
from .export import export_program

__all__ = ["plan_to_dot", "graph_dump", "main"]

_LOG = logging.getLogger(__name__)


def plan_to_dot(model) -> str:
    lines = ["digraph yolojax {", "  rankdir=TB;", '  node [shape=box, fontsize=10];']
    prev = "input"
    lines.append('  input [label="images (NHWC)"];')
    slots = {}
    for i, op in enumerate(model.plan):
        kind = op[0]
        name = f"op{i}"
        if kind == "conv":
            d = op[1]
            label = f"{d.name}: conv{d.ksize}x{d.ksize}/{d.stride} {d.in_ch}->{d.out_ch}"
            if d.groups > 1:
                label += " dw"
            lines.append(f'  {name} [label="{label}"];')
            lines.append(f"  {prev} -> {name};")
            prev = name
        elif kind == "pool":
            lines.append(f'  {name} [label="maxpool {op[1]}/{op[2]}"];')
            lines.append(f"  {prev} -> {name};")
            prev = name
        elif kind == "mark":
            slots[op[1]] = prev
        elif kind == "load":
            prev = slots[op[1]]
        elif kind == "reorg":
            lines.append(f'  {name} [label="reorg /{op[1]}"];')
            lines.append(f"  {prev} -> {name};")
            prev = name
        elif kind == "concat":
            lines.append(f'  {name} [label="concat"];')
            lines.append(f"  {prev} -> {name};")
            lines.append(f"  {slots[op[1]]} -> {name};")
            prev = name
    lines.append('  output [label="raw head"];')
    lines.append(f"  {prev} -> output;")
    lines.append("}")
    return "\n".join(lines)


def graph_dump(model, size: int, device="cuda", seed: int = 0):
    """(program text, fx code, program) of the folded forward + decode at
    batch 1, on weights drawn from ``torch.Generator().manual_seed(seed)``."""
    params, state = model.init(torch.Generator().manual_seed(seed), device)
    program = export_program(model, model.fold(params, state), model.anchors, size)
    return str(program), program.graph_module.code, program


def main(argv=None):
    parser = make_parser("dump the model graph: plan DOT, torch.export program, fx code")
    parser.add_argument("--size", type=int, default=416)
    parser.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    parser.add_argument("-o", "--output", default="demo_graph_out")
    args = parser.parse_args(argv)
    config = setup(args)

    category, anchors, model = build(config)
    os.makedirs(args.output, exist_ok=True)
    dot = plan_to_dot(model)
    with open(os.path.join(args.output, "plan.dot"), "w") as f:
        f.write(dot)
    try:
        import graphviz

        graphviz.Source(dot).render(os.path.join(args.output, "plan"), format="png",
                                    cleanup=True)
    except Exception as e:  # the graphviz package or its binary may be absent
        _LOG.info("graphviz render skipped: %s", e)

    text, code, _ = graph_dump(model, args.size, args.device)
    with open(os.path.join(args.output, "model.graph.txt"), "w") as f:
        f.write(text)
    with open(os.path.join(args.output, "model.fx.py"), "w") as f:
        f.write(code)
    _LOG.info("wrote plan.dot / model.graph.txt / model.fx.py under %s", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
