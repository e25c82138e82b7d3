"""The knee of a camera-stream cell: one sweep of camera counts, one process.

    python3 perfbench/sweep_cameras.py --workload darknet19-voc416.cameras-under-knee \
        --cameras 40-120/5 --seconds 8 --seed 5

Builds the cell's model and weights once, warms the padded shapes, then for
each camera count runs the cell's open loop (``drivers/open_stream.py``) for
``--seconds`` after its lead-in and prints one JSON line: the p50 and p95
latency of the frames due in the window, the median latency of the frames
due in its first and its last fifth (a backlog that grows shows as the
second far above the first), frames a call and calls.  The knee is the
highest count whose p95 stays at or under ``--limit-ms`` with no growing
backlog.  Needs a CUDA device; benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def padded_shapes(counts, traffic: dict, drv) -> list[int]:
    """Every padded batch size of the sweep's camera counts (the muxer's
    ``batch`` may follow the count)."""
    return sorted({b for n in counts for b in drv.padded_shapes(dict(traffic, cameras=n))})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", default="darknet19-voc416.cameras-under-knee")
    parser.add_argument("--cameras", default="40-120/5")
    parser.add_argument("--seconds", type=float, default=8.0)
    parser.add_argument("--seed", type=int, default=5)
    parser.add_argument("--limit-ms", type=float, default=100.0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from perfbench.harness import inputs, program
    from perfbench.harness.cell import Cell
    from perfbench.harness.context import Context

    if not torch.cuda.is_available():
        print("sweep_cameras: needs a CUDA device", file=sys.stderr)
        return 3
    cell = Cell(args.workload)
    rng, _, step = args.cameras.partition("/")
    lo, _, hi = rng.partition("-")
    counts = range(int(lo), int(hi or lo) + 1, int(step or 5))
    base = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                   device=torch.device("cuda", 0), t_process=time.perf_counter())
    cfg, traffic = base.config, base.traffic
    params, state = inputs.make_params(cfg, args.seed, base.device)
    frames = inputs.make_frames(traffic["pool"], cfg["size"], args.seed, base.device)
    detect, folded = program.detect_fn(program.build_model(cfg), params, state, traffic)
    drv = cell.driver
    for b in padded_shapes(counts, traffic, drv):
        detect(folded, frames[:b])
    base.sync()
    for n in counts:
        ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                      device=base.device, t_process=0.0,
                      overrides={"traffic": {"cameras": n}})
        lead = ctx.traffic["lead_in_s"]
        due, rows = drv.schedule(ctx.traffic, args.seed, args.seconds)
        done, _, batches = drv.serve(ctx, detect, folded, frames, due, rows, lead)
        counted = due >= lead
        lat = (done[counted] - due[counted]) * 1e3
        served = np.isfinite(lat)
        fifth = max(1, len(lat) // 5)
        first, last = lat[:fifth], lat[-fifth:]
        print(json.dumps({
            "cameras": n, "frames_per_s": n * ctx.traffic["fps"],
            "p50_ms": float(np.percentile(lat[served], 50)),
            "p95_ms": float(np.percentile(lat[served], 95)),
            "first_fifth_p50_ms": float(np.median(first)),
            "last_fifth_p50_ms": float(np.median(last)),
            "unserved": int((~served).sum()), "frames": int(len(lat)),
            "batch": drv.batch_size(ctx.traffic), "batch_mean": float(np.mean(batches)),
            "calls": len(batches)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
