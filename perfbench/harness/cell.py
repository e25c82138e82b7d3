"""A cell of ``BENCHMARK.json`` resolved by name to its files:
``configs/<config>.json`` (through the configuration's ``file``),
``traffic/<traffic>.json``, ``drivers/<driver>.py`` (the driver the mix
names), ``metrics/<metric>.py`` for each per-layer metric the cell reports,
and ``limits/<workload>.json``, the limits of its check."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["Cell", "ROOT", "HERE", "load_module"]

HERE = Path(__file__).resolve().parents[1]        # perfbench/
ROOT = HERE.parent                                 # the checkout


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name`` (metric files
    carry a dot in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, workload: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric.get("moves") in reported


class Cell:
    def __init__(self, workload: str, root: Path = ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
        if entry is None:
            raise SystemExit(f"perfbench: no workload {workload!r} in BENCHMARK.json")
        self.name, self.chips = workload, entry["chips"]
        config = next(c for c in spec["configs"] if c["name"] == entry["config"])
        self.config = json.loads((root / config["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
        self.driver = load_module(HERE / "drivers" / f"{self.traffic['driver']}.py",
                                  f"perfbench_driver_{self.traffic['driver']}")
        self.end_to_end = [m for m in spec["end_to_end"] if _applies(m, workload)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in spec["per_layer"] if _applies(m, workload, reported)]
        limits = HERE / "limits" / f"{workload}.json"
        self.limits = json.loads(limits.read_text())["limits"] if limits.exists() else {}

    def metric_reader(self, name: str):
        return load_module(HERE / "metrics" / f"{name}.py", f"perfbench_metric_{name}").read
