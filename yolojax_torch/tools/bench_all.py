"""The bench's artifacts for a round, one job at a time — counterpart of
``scripts/bench_all.py``.

    python -m yolojax_torch.tools.bench_all --round 14 [--skip TAG …] [--only TAG …]

Runs ``python -m yolojax_torch.tools.bench`` once in a subprocess for each
job of :data:`JOBS` (the reference's 21, with its tags, environments and
order), one at a time so that no two share the card, and writes each job's
JSON line to ``build/bench_torch/BENCH_<TAG>_r<N>.json``, apart from the
TPU's ``BENCH_*_r<N>.json`` at the repo root.  The bench's line carries the
card's name and power limit (``device``); the JSON lines the bench prints
to stderr (e2e's host / copy / step split) are folded into the artifact's
``diagnostics``.  A job that times out, exits non-zero or prints no JSON
line is reported as FAILED and the loop goes on.  ``--only`` runs just the
tags named, ``--skip`` leaves the tags named out (both case-blind).  The
environment is the caller's with the job's on top (``BENCH_DEVICE``,
``BENCH_ITERS`` … pass through where a job does not set them).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

__all__ = ["JOBS", "BENCH", "OUT_DIR", "TIMEOUT", "main"]

REPO = Path(__file__).resolve().parents[2]
BENCH = [sys.executable, "-m", "yolojax_torch.tools.bench"]
OUT_DIR = REPO / "build" / "bench_torch"
TIMEOUT = 3600

JOBS = [
    # artifact tag, env overrides
    ("MOBILENET", {"BENCH_MODEL": "mobilenet"}),
    ("TINY", {"BENCH_MODEL": "tiny"}),
    ("TRAIN", {"BENCH_MODE": "train"}),
    ("MOBILENET_TRAIN", {"BENCH_MODE": "train", "BENCH_MODEL": "mobilenet"}),
    ("TINY_TRAIN", {"BENCH_MODE": "train", "BENCH_MODEL": "tiny"}),
    # the e2e loop, batch k+1's host-to-device copy riding while step k
    # computes
    ("E2E", {"BENCH_MODE": "e2e", "BENCH_BATCH": "32", "BENCH_ITERS": "10"}),
    # its serialised attribution: each phase closed by a synchronize, so
    # the rate reads the phases' sum, not the overlapped loop
    ("E2E_DECOMP", {"BENCH_MODE": "e2e", "BENCH_BATCH": "32",
                    "BENCH_ITERS": "10", "BENCH_E2E_DECOMP": "1"}),
    # the same loop gathering its batches from the device-resident dataset,
    # and that loop's attribution
    ("E2E_DEVDATA", {"BENCH_MODE": "e2e", "BENCH_BATCH": "32",
                     "BENCH_ITERS": "30", "BENCH_E2E_DEVDATA": "1"}),
    ("E2E_DEVDATA_DECOMP", {"BENCH_MODE": "e2e", "BENCH_BATCH": "32",
                            "BENCH_ITERS": "30", "BENCH_E2E_DEVDATA": "1",
                            "BENCH_E2E_DECOMP": "1"}),
    # the train step at larger batches
    ("TRAIN_B192", {"BENCH_MODE": "train", "BENCH_BATCH": "192"}),
    ("TRAIN_B256", {"BENCH_MODE": "train", "BENCH_BATCH": "256"}),
    # B=1 detect latency (BASELINE config 1)
    ("LATENCY", {"BENCH_MODE": "latency"}),
    # detect and train at the other sizes; 416 stays the headline
    ("320", {"BENCH_SIZE": "320"}),
    ("544", {"BENCH_SIZE": "544"}),
    ("608", {"BENCH_SIZE": "608"}),
    ("TRAIN_320", {"BENCH_MODE": "train", "BENCH_SIZE": "320"}),
    ("TRAIN_544", {"BENCH_MODE": "train", "BENCH_SIZE": "544"}),
    ("TRAIN_608", {"BENCH_MODE": "train", "BENCH_SIZE": "608", "BENCH_BATCH": "64"}),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--round", required=True, help="round number, e.g. 14")
    ap.add_argument("--skip", nargs="*", default=[], help="tags to skip")
    ap.add_argument("--only", nargs="*", default=None,
                    help="run just these tags (single-job re-runs)")
    args = ap.parse_args(argv)
    only = None if args.only is None else {s.lower() for s in args.only}
    skip = {s.lower() for s in args.skip}

    for tag, env_over in JOBS:
        if only is not None and tag.lower() not in only:
            continue
        if tag.lower() in skip:
            print(f"{tag}: skipped", flush=True)
            continue
        env = dict(os.environ, **env_over)
        print(f"{tag}: running the bench with {env_over} ...", flush=True)
        try:
            proc = subprocess.run(BENCH, cwd=REPO, capture_output=True, text=True, env=env,
                                  timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            print(f"{tag}: FAILED (timeout after {TIMEOUT} s) — continuing", flush=True)
            continue
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            if proc.returncode != 0:
                raise json.JSONDecodeError("nonzero exit", line, 0)
            rec = json.loads(line)
        except json.JSONDecodeError:
            print(f"{tag}: FAILED (rc={proc.returncode}) — continuing\n"
                  f"stdout: {proc.stdout[-2000:]}\n"
                  f"stderr: {proc.stderr[-2000:]}", flush=True)
            continue
        # the bench prints its diagnostics (e2e's split) to stderr, so that
        # its stdout holds the one metric line
        for sline in proc.stderr.splitlines():
            sline = sline.strip()
            if sline.startswith("{"):
                try:
                    rec.setdefault("diagnostics", []).append(json.loads(sline))
                except json.JSONDecodeError:
                    pass
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        path = OUT_DIR / f"BENCH_{tag}_r{args.round}.json"
        path.write_text(json.dumps(rec) + "\n")
        print(f"{tag}: {line} -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
