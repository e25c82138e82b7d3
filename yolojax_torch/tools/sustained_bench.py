"""Sustained detect throughput on one card — counterpart of
``scripts/sustained_bench.py``.

    python -m yolojax_torch.tools.sustained_bench --round 01 [--seconds 60]
        [--batch 128] [--size 416] [--window 8] [--out PATH]

Runs the bench's detect call (``tools/bench.py::make_infer_run``; the same
``BENCH_MODEL``, ``BENCH_PALLAS``, ``BENCH_SATURATED`` and ``BENCH_DEVICE``)
for about ``--seconds`` after two warm calls, in windows of ``--window``
calls closed by a synchronize, and records:

- the aggregate rate and each window's (p5 / p50 / p95): a window holds the
  host's launch time and the closing synchronize, the same in every window;
- drift: the mean rate of the last quarter of the windows against the
  first quarter's (a clock that throttles or a leak would show there);
- the process's resident memory at the start and at the end
  (``/proc/self/status``).

Writes the record (the bench's metric / value / unit / vs_baseline, the
stability fields and ``device``) to ``--out`` — by default
``build/bench_torch_sustained_r<round>.json`` under the repo root, apart
from the reference's ``BENCH_*`` artifacts of another device — and prints it
as one JSON line.  Each call is one detect call: the reference's in-program
repeat is 1 here (``in_graph_repeat``).  A model other than Darknet-19 is
named in the metric, as the bench names it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import bench


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return float("nan")


def _positive(value: str) -> float:
    x = float(value)
    if not x > 0:
        raise argparse.ArgumentTypeError(f"must be > 0, not {value}")
    return x


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--round", required=True, help="round number, e.g. 01")
    ap.add_argument("--seconds", type=_positive, default=60.0,
                    help="target sustained duration (wall, after the warm-up)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--window", type=int, default=8, help="detect calls per timed window")
    ap.add_argument("--out", default=None,
                    help="record path (default build/bench_torch_sustained_r<round>.json)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = bench.bench_device()
    run, folded, images = bench.make_infer_run(args.batch, args.size, device)
    float(run(folded, images))
    float(run(folded, images))
    rss_start = _rss_mb()

    imgs_per_window = args.batch * args.window
    rates: list[float] = []
    bench.sync(device)
    t_begin = time.perf_counter()
    while not rates or time.perf_counter() - t_begin < args.seconds:
        t0 = time.perf_counter()
        for _ in range(args.window):
            run(folded, images)
        bench.sync(device)
        rates.append(imgs_per_window / (time.perf_counter() - t0))
    duration = time.perf_counter() - t_begin
    rss_end = _rss_mb()

    rates_np = np.asarray(rates)
    q = max(1, len(rates) // 4)
    first_q = float(rates_np[:q].mean())
    last_q = float(rates_np[-q:].mean())
    overall = imgs_per_window * len(rates) / duration
    which = os.environ.get("BENCH_MODEL", "darknet")
    model_tag = "" if which == "darknet" else f"_{which}"
    baseline = bench.BASELINE_FPS_BY_SIZE.get(args.size, bench.BASELINE_FPS)
    rec = {
        "metric": f"sustained_infer{model_tag}_{args.size}",
        "value": round(overall, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(overall / baseline, 2),
        "seconds": round(duration, 1),
        "windows": len(rates),
        "dispatches": len(rates) * args.window,
        "batch": args.batch,
        "in_graph_repeat": 1,
        "window_rate_p5": round(float(np.percentile(rates_np, 5)), 2),
        "window_rate_p50": round(float(np.percentile(rates_np, 50)), 2),
        "window_rate_p95": round(float(np.percentile(rates_np, 95)), 2),
        "drift_last_vs_first_quartile": round(last_q / first_q - 1.0, 4),
        "rss_mb_start": round(rss_start, 1),
        "rss_mb_end": round(rss_end, 1),
        "pallas": os.environ.get("BENCH_PALLAS", ""),
        "device": bench.card(device),
        "note": ("a window is its detect calls launched back to back and one "
                 "synchronize at its end on a local card: the host's launch time "
                 "and the synchronize are inside every window alike; drift and "
                 "RSS are the stability claims"),
    }
    path = args.out or str(bench.REPO / "build" / f"bench_torch_sustained_r{args.round}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f)
        f.write("\n")
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
