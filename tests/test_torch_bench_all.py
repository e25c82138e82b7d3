"""``python -m yolojax_torch.tools.bench_all`` against ``scripts/bench_all.py``.

* its jobs are the reference's: the same tags, environments and order
  (the script is loaded by its path: it imports no JAX);
* with the bench command swapped for a stub that prints one JSON line
  (which names its environment) and a diagnostic on stderr, and fails for
  one job: each artifact's path under ``build/bench_torch`` (here a
  temporary directory) and content, the ``diagnostics`` list, ``--only``
  and ``--skip``, and a failing job reported as FAILED while the loop goes
  on.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from yolojax_torch.tools import bench_all

ROOT = Path(__file__).resolve().parents[1]

STUB = r"""
import json, os, sys
env = {k: v for k, v in os.environ.items() if k.startswith("BENCH_") and k != "BENCH_DEVICE"}
if env.get("BENCH_MODE") == "latency":
    print("boom", file=sys.stderr)
    sys.exit(3)
print("a log line first")
print(json.dumps({"metric": "stub", "value": 1.5, "unit": "images/sec", "vs_baseline": 0.1,
                  "device": "NVIDIA H100 80GB HBM3, 700.00 W", "env": env}))
print("not json", file=sys.stderr)
print(json.dumps({"e2e_decomposition": {"host_ms": 1.0}}), file=sys.stderr)
print("{broken", file=sys.stderr)
"""


def test_jobs_are_the_reference_jobs():
    spec = importlib.util.spec_from_file_location("reference_bench_all",
                                                  ROOT / "scripts" / "bench_all.py")
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    assert bench_all.JOBS == reference.JOBS
    assert len({tag for tag, _ in bench_all.JOBS}) == len(bench_all.JOBS) == 18
    assert bench_all.TIMEOUT == 3600


@pytest.fixture
def stubbed(tmp_path, monkeypatch):
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    monkeypatch.setattr(bench_all, "BENCH", [sys.executable, str(stub)])
    monkeypatch.setattr(bench_all, "OUT_DIR", tmp_path / "build" / "bench_torch")
    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    return tmp_path / "build" / "bench_torch"


def test_only_writes_each_job_with_its_diagnostics(stubbed, capsys):
    assert bench_all.main(["--round", "14", "--only", "e2e_decomp", "TINY"]) == 0
    out = capsys.readouterr().out
    assert sorted(p.name for p in stubbed.iterdir()) == ["BENCH_E2E_DECOMP_r14.json",
                                                        "BENCH_TINY_r14.json"]
    jobs = dict(bench_all.JOBS)
    for tag in ("TINY", "E2E_DECOMP"):
        rec = json.loads((stubbed / f"BENCH_{tag}_r14.json").read_text())
        assert rec["env"] == jobs[tag] and rec["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
        assert rec["diagnostics"] == [{"e2e_decomposition": {"host_ms": 1.0}}]
        assert f"{tag}: running the bench with {jobs[tag]}" in out
        assert f"-> {stubbed / f'BENCH_{tag}_r14.json'}" in out
    # in JOBS' order, not --only's
    assert out.index("TINY: running") < out.index("E2E_DECOMP: running")


def test_a_failing_job_is_reported_and_the_loop_goes_on(stubbed, capsys):
    assert bench_all.main(["--round", "07", "--skip", "mobilenet", "e2e", "e2e_decomp",
                           "e2e_devdata", "e2e_devdata_decomp"]) == 0
    out = capsys.readouterr().out
    assert "LATENCY: FAILED (rc=3) — continuing" in out and "stderr: boom" in out
    assert "MOBILENET: skipped" in out and "E2E_DEVDATA: skipped" in out
    skipped = {"MOBILENET", "E2E", "E2E_DECOMP", "E2E_DEVDATA", "E2E_DEVDATA_DECOMP", "LATENCY"}
    want = {f"BENCH_{tag}_r07.json" for tag, _ in bench_all.JOBS if tag not in skipped}
    assert {p.name for p in stubbed.iterdir()} == want
    # the jobs after the failing one ran
    assert "TRAIN_608: " in out.split("LATENCY: FAILED")[1]
    rec = json.loads((stubbed / "BENCH_TRAIN_608_r07.json").read_text())
    assert rec["env"] == {"BENCH_MODE": "train", "BENCH_SIZE": "608", "BENCH_BATCH": "64"}


def test_a_job_past_the_timeout_is_reported(stubbed, monkeypatch, capsys):
    def too_long(*args, **kwargs):
        raise subprocess.TimeoutExpired(args[0], kwargs["timeout"])

    monkeypatch.setattr(bench_all.subprocess, "run", too_long)
    assert bench_all.main(["--round", "01", "--only", "608"]) == 0
    assert "608: FAILED (timeout after 3600 s) — continuing" in capsys.readouterr().out
    assert not stubbed.exists()
