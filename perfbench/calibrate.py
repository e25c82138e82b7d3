"""Readings that the check's limits are set from, for one cell, in one process.

    python3 perfbench/calibrate.py --workload darknet19-voc416.detect-b128 \
        --seeds 1-12 --control-seeds 101-103 --faults half_batch,alter_answer --seconds 2

Each (mode, seed) is one run of the cell's driver with a short window: the
port on ``--seeds`` (the lower readings), the control on ``--control-seeds``
(the reference in the program's place, rounded to fp8: the upper
readings), each fault of ``--faults`` (``harness/faults.py``) on the
control seeds, and the reference rounded to bf16 on ``--bf16-seeds``.
One JSON line a run on standard output, and the lines in ``--out`` too.
Needs a CUDA device; benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list[int]:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="1-12")
    parser.add_argument("--control-seeds", default="101-103")
    parser.add_argument("--faults", default="")
    parser.add_argument("--bf16-seeds", default="",
                        help="seeds on which the reference rounded to bf16 stands in")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness.cell import Cell
    from perfbench.harness.context import Context

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    cell = Cell(args.workload)
    runs = [("port", None, s) for s in seeds(args.seeds)]
    runs += [("control", None, s) for s in seeds(args.control_seeds)]
    runs += [("port", f, s) for f in filter(None, args.faults.split(","))
             for s in seeds(args.control_seeds)]
    runs += [("reference_bf16", None, s) for s in seeds(args.bf16_seeds)]
    out = open(args.out, "a") if args.out else None
    try:
        for program, fault, seed in runs:
            ctx = Context(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                          device=torch.device("cuda", 0), t_process=time.perf_counter(),
                          program=program, fault=fault)
            t0 = time.perf_counter()
            res = cell.driver.run(ctx)
            line = json.dumps({"workload": cell.name, "program": program, "fault": fault,
                               "seed": seed, "numbers": res.numbers,
                               "end_to_end": res.end_to_end, "attempted": res.attempted,
                               "failed": res.failed, "seconds": time.perf_counter() - t0})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
