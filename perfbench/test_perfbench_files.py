"""BENCHMARK.json against the benchmark's contract, and every entry resolved
to its files by name."""

from __future__ import annotations

import json
import re

import pytest

from perfbench.harness.cell import HERE, ROOT, Cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"] and SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    cells = len(SPEC["workloads"])
    # a full check: 2 + 14 runs a cell, each run_seconds + 60, 180 s a cell, 1200 spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert 1 <= cells <= 24 and four <= max(1, cells // 4)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_one_line_texts():
    items = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [i["name"] for i in SPEC[group]]
        assert len(names) == len(set(names)), group
    for item in items:
        assert NAME.match(item["name"]), item["name"]
        for key in ("why", "layer", "source"):
            if key in item:
                text = item[key]
                assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline.detect") or m["name"].endswith("_roofline")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves_to_its_files(workload):
    cell = Cell(workload)
    assert (HERE / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert hasattr(cell.driver, "run")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names, (m["name"], names)
        assert callable(cell.metric_reader(m["name"]))
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_under_paths(config):
    assert config["file"].startswith("perfbench/configs/")
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and config["reduced"] == []
    assert any(w["config"] == config["name"] for w in SPEC["workloads"])


def test_every_traffic_metric_and_limit_file_is_used():
    traffic = {w["traffic"] for w in SPEC["workloads"]}
    assert {p.stem for p in (HERE / "traffic").glob("*.json")} == traffic
    metrics = {m["name"] for m in SPEC["per_layer"]}
    assert {p.name[:-3] for p in (HERE / "metrics").glob("*.py")} == metrics
    assert {p.stem for p in (HERE / "limits").glob("*.json")} == set(CELLS)
