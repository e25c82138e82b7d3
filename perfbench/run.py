"""The benchmark of ``yolojax_torch`` on one NVIDIA H100: one run of one cell.

    python3 perfbench/run.py --workload darknet19-voc416.detect-b128 --seed 7 --seconds 10 --trace 0

The cell is looked up in ``BENCHMARK.json``; its configuration, traffic mix,
driver and per-layer metrics are files found by name (``perfbench/README.md``).
The run makes its weights and inputs on the card from ``--seed``, warms up
every shape the traffic uses (set-up), measures for ``--seconds``, and with
``--trace 1`` profiles a short segment after the window for the per-layer
metrics.  Once the window has closed it compares what the timed path produced
with the plain reference (``reference/yolo.py``) and prints each compared
number beside its limit on standard error, then one JSON line on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``.

It exits with code 3 and prints no result where torch sees no CUDA device or
fewer than the cell asks for, and with code 4 where JAX or the JAX package was
loaded in this process.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
CACHES = {"CUDA_CACHE_PATH": "build/perfbench/cuda_cache",
          "TRITON_CACHE_DIR": "build/perfbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/perfbench/torch_extensions"}
# Python's bytecode too: an installation that ships none for torch and sets
# PYTHONDONTWRITEBYTECODE compiles torch's sources again in every run, about
# 2 s of set-up on the H100's host; set before torch and the port are imported
sys.pycache_prefix = str(ROOT / "build/perfbench/pycache")
sys.dont_write_bytecode = False
FORBIDDEN = ("jax", "jaxlib", "flax", "yolojax")


def process_start() -> float:
    """The process's start on ``time.perf_counter``'s scale (from its start
    time since boot, to a clock tick); this module's import time where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return T_IMPORT
    return time.perf_counter() - age if 0 <= age < 600 else T_IMPORT


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    t_process = process_start()
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT))

    from perfbench.harness.cell import Cell
    from perfbench.harness.context import Context

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device("cuda", 0), t_process=t_process)
    ctx.marks.append(("start", t_process))
    ctx.mark("imports")
    torch.set_num_threads(1)       # one process with few threads: the timed path runs on the card
    torch.cuda.init()
    torch.empty(1, device=ctx.device)
    ctx.mark("cuda_context")
    out = cell.driver.run(ctx)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}; the port must not",
              file=sys.stderr)
        return 4
    phases = [(what, t - t_prev) for (_, t_prev), (what, t) in zip(ctx.marks, ctx.marks[1:])]
    if out.record is not None:
        out.record["phases"] = dict(phases)
    result = report(ctx, out)
    print("phases " + " ".join(f"{what}={s:.3f}s" for what, s in phases), file=sys.stderr)
    print("numbers " + json.dumps(out.numbers), file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def report(ctx, out) -> dict:
    """The result line of a run from the driver's outcome."""
    from perfbench.harness.compare import judge

    cell = ctx.cell
    metrics = {}
    if ctx.trace:
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"])(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    correct, rows = judge(out.numbers, cell.limits)
    correct = correct and out.failed == 0 and all(
        math.isfinite(v["value"]) for v in metrics.values())
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
              "count": 1, "memory_peak_bytes": out.memory_peak_bytes,
              "power_limit": power_limit()}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if ctx.trace:
        seg = out.record["segment"]
        device.update(busy_s=seg["busy_s"], window_s=seg["window_s"])
        result["breakdown"] = {"device_ops": seg["device_ops"][:10],
                               "idle_gaps": seg["idle_gaps"][:10]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return result


if __name__ == "__main__":
    sys.exit(main())
