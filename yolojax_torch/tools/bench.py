"""The port's measuring entry point — counterpart of the repo root's
``bench.py``: images/s of the flagship YOLOv2 on one card, one JSON line.

    python -m yolojax_torch.tools.bench                      # infer: Darknet-19, 416, B=128
    BENCH_MODE=train BENCH_BATCH=16 python -m yolojax_torch.tools.bench
    BENCH_MODEL=mobilenet BENCH_PALLAS=nms,fusedpost,dwconv,dwsep python -m yolojax_torch.tools.bench

The environment is ``bench.py``'s, with its defaults:

* ``BENCH_MODE``: ``infer`` (the default) — fused detect (folded
  forward → decode → per-class NMS, threshold 0.005, overlap 0.45, topk 100)
  on a seeded batch, images/s; ``latency`` — the same at B=1, ms per image
  (``BENCH_BATCH`` ignored); ``train`` — the train step (no augmentation,
  SGD with momentum 0.9, the gradient clipped at 5) on a seeded batch of 30
  boxes an image, images/s; ``e2e`` — the train CLI's loop
  (``cli/train.py::Train``) on 256 synthetic VOC images through the record
  cache, the decoded-canvas cache, the threaded loader, the overlapped
  copies and the on-device augmentation, images/s; ``pipeline`` — the host
  loader alone (JPEG decode, canvas pack, collate), images/s.  ``e2e`` and
  ``pipeline`` need OpenCV and refuse without it;
* ``BENCH_MODEL``: ``darknet`` | ``tiny`` | ``mobilenet`` (infer, latency
  and train only), ``BENCH_SIZE``: 320 | 416 | 544 | 608 (the same three
  modes), ``BENCH_BATCH`` (128), ``BENCH_ITERS`` (30);
* ``BENCH_PALLAS``: comma-separated ``[model] pallas`` tokens in place of
  the flagship's ``nms,fusedpost`` (``nms`` alone routes the decoded
  head to the nms_select kernel; ``dwconv,dwsep`` MobileNet's depthwise
  layers to theirs; ``pool`` the pools of Darknet-19 and Tiny to theirs);
* ``BENCH_SATURATED=1`` keeps the fresh init's objectness (every score
  near 0.5, the NMS at its worst case) instead of the logit −6;
* ``BENCH_E2E_DEVDATA=1``: e2e gathers its batches from the device-resident
  dataset (``[data] device_dataset``); ``BENCH_E2E_DECOMP=1``: e2e
  serialises each phase and prints its host / copy / step split to stderr;
* ``BENCH_DEVICE``: ``cuda`` (the default; with no CUDA device it raises)
  or ``cpu``.

The printed line holds ``bench.py``'s metric name, value, unit and
``vs_baseline`` — against the YOLO9000 paper's Titan X rates, the
reference's own yardstick, not a number of this card — plus ``device``: the
card's name and power limit as ``nvidia-smi`` gives them, or ``cpu``.

What differs from ``bench.py``: the reference chains four detect calls in
one compiled program per dispatch to hide a gap its TPU's remote dispatch
adds between programs.  A local card has no such gap, so here ``iters``
eager calls run back to back between a synchronize before and one after,
and the rate is ``batch × iters / dt``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ..entry import flagship
from ..models.inference import Inference
from ..ops.loss import LossConfig
from ..parallel.mesh import make_train_step
from ..utils.train import Optimizer

__all__ = ["BASELINE_FPS_BY_SIZE", "bench_device", "card", "make_infer_run", "bench_infer",
           "bench_latency", "train_batch", "train_setup", "bench_train", "bench_e2e",
           "bench_pipeline", "main"]

REPO = Path(__file__).resolve().parents[2]
# The YOLO9000 paper's Table 3 (Titan X): FPS at the sizes it publishes; 320
# takes 288's rate and 608 takes 544's (bench.py's table, copied)
BASELINE_FPS_BY_SIZE = {288: 91.0, 320: 91.0, 416: 67.0, 544: 40.0, 608: 40.0}
BASELINE_FPS = BASELINE_FPS_BY_SIZE[416]
THRESHOLD, OVERLAP, TOPK = 0.005, 0.45, 100
# the objectness logit of a fresh head: a trained detector's background
# density (about 2.7 % of (cell, class) scores over the threshold) instead of
# the init's 0.5 everywhere, which saturates the NMS
OBJECTNESS = -6.0
TRAIN_BOXES = 30
TRAIN_WEIGHTS = {"coord": 1.0, "object": 5.0, "noobject": 1.0, "cls": 1.0, "prior": 0.01}


def bench_device() -> torch.device:
    """``BENCH_DEVICE`` (``cuda`` by default); a ``cuda`` request with no
    CUDA device raises."""
    device = torch.device(os.environ.get("BENCH_DEVICE", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("BENCH_DEVICE=cuda, but torch sees no CUDA device; "
                           "set BENCH_DEVICE=cpu to run the bench on the CPU")
    return device


def card(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    return subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _resolve(device) -> torch.device:
    return bench_device() if device is None else torch.device(device)


def make_infer_run(batch: int, size: int, device=None, params=None, state=None):
    """The detect closure shared by :func:`bench_infer` and
    ``tools/sustained_bench.py``: returns ``(run, folded, images)``, where
    ``run(folded, images)`` is one detect call of a batch and returns the sum
    of its picks' scores, a scalar on the device.

    The model is ``flagship(backbone=BENCH_MODEL)``, initialised from
    ``torch.Generator().manual_seed(0)`` unless ``params`` and ``state`` (the
    port's layout, e.g. ``utils/checkpoint.py::from_jax`` of the reference's)
    are given; the objectness logit is set to −6 unless
    ``BENCH_SATURATED=1``; ``BENCH_PALLAS`` replaces the kernel tokens; BN
    is folded.  The route is ``detect_fn``'s: ``fusedpost`` → the fused
    decode+NMS kernel, else ``nms`` → decode + the nms_select kernel, else
    decode + the plain NMS.  ``images`` is a seeded uniform batch."""
    device = _resolve(device)
    model = flagship(backbone=os.environ.get("BENCH_MODEL", "darknet"))
    if params is None:
        params, state = model.init(torch.Generator().manual_seed(0), device)
    else:
        params = {k: {n: v.to(device) for n, v in lp.items()} for k, lp in params.items()}
        state = {k: {n: v.to(device) for n, v in lp.items()} for k, lp in state.items()}
    if not int(os.environ.get("BENCH_SATURATED", "0")):
        b = params["out"]["b"].clone()
        b.view(-1, 5 + model.num_classes)[:, 4] = OBJECTNESS
        params = dict(params, out=dict(params["out"], b=b))
    tokens = frozenset(os.environ.get("BENCH_PALLAS", "").split(",")) - {""}
    if tokens:
        # before the fold: it stores the weight layouts the selected kernels read
        model.pallas = tokens
    inference = Inference(model)
    folded = inference.fold(params, state)
    detect = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)

    def run(folded, images):
        return detect(folded, images).conf.sum(dtype=torch.float32)

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32))
    return run, folded, images.to(device)


def bench_infer(batch: int, iters: int, size: int = 416, device=None) -> float:
    """Images/s of ``iters`` detect calls after two warm ones."""
    device = _resolve(device)
    run, folded, images = make_infer_run(batch, size, device)
    float(run(folded, images))
    float(run(folded, images))
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        run(folded, images)
    sync(device)
    return batch * iters / (time.perf_counter() - t0)


def bench_latency(batch: int, iters: int, size: int = 416, device=None) -> float:
    """Ms per image of one detect call at B=1 (BASELINE config 1), over
    ``max(iters, 100)`` calls; ``batch`` is ignored."""
    return 1000.0 / bench_infer(1, max(iters, 100), size, device)


def train_batch(batch: int, size: int) -> dict:
    """``bench.py``'s synthetic train batch, drawn from
    ``np.random.default_rng(0)`` in its order: centers, halves, images,
    classes; 30 boxes an image."""
    rng = np.random.default_rng(0)
    center = rng.uniform(0.2, 0.8, (batch, TRAIN_BOXES, 2)).astype(np.float32)
    half = rng.uniform(0.02, 0.3, (batch, TRAIN_BOXES, 2)).astype(np.float32)
    images = rng.uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    return {"images": images,
            "yx_min": np.clip(center - half, 0, 1), "yx_max": np.clip(center + half, 0, 1),
            "cls": rng.integers(0, 20, (batch, TRAIN_BOXES)).astype(np.int32),
            "valid": np.ones((batch, TRAIN_BOXES), bool)}


def train_setup(batch: int, size: int, device=None, params=None, state=None):
    """``(step, (params, state, opt_state), data, seen)`` of :func:`bench_train`:
    ``flagship(backbone=BENCH_MODEL)`` from seed 0 (or ``params``, ``state``),
    SGD at 1e-3 with momentum 0.9 after a global-norm clip at 5, the
    reference's loss weights, ``seen`` past the warmup."""
    device = _resolve(device)
    model = flagship(backbone=os.environ.get("BENCH_MODEL", "darknet"))
    if params is None:
        params, state = model.init(torch.Generator().manual_seed(0), device)
    optimizer = Optimizer("sgd", schedule=lambda count: 1e-3, clip=5.0, momentum=0.9)
    step = make_train_step(model, optimizer, TRAIN_WEIGHTS, LossConfig())
    data = {k: torch.from_numpy(v).to(device) for k, v in train_batch(batch, size).items()}
    return step, (params, state, optimizer.init(params)), data, 1 << 30


def bench_train(batch: int, iters: int, size: int = 416, device=None) -> float:
    """Images/s of ``iters`` train steps after one warm step."""
    device = _resolve(device)
    step, (params, state, opt_state), data, seen = train_setup(batch, size, device)
    params, state, opt_state, m = step(params, state, opt_state, data, seen)
    float(m["total"])
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        params, state, opt_state, m = step(params, state, opt_state, data, seen)
    float(m["total"])
    sync(device)
    return batch * iters / (time.perf_counter() - t0)


def _require_cv2(mode: str, why: str):
    try:
        import cv2
    except ImportError as exc:
        raise SystemExit(f"bench {mode}: needs OpenCV (cv2), which does not import here "
                         f"({exc}); {why}") from None
    return cv2


def _e2e_overlay(root: str, voc: str, category: str, batch: int, size: int,
                 devdata: bool) -> str:
    path = os.path.join(root, "bench.ini")
    with open(path, "w") as f:
        f.write(f"""[config]
root = {root}/artifacts
[cache]
datasets = yolojax.data.voc
category = {category}
voc_roots = {voc}
[model]
name = bench_e2e
[data]
batch_size = {batch}
max_boxes = 10
workers = {os.cpu_count() or 4}
decoded_cache = 1
device_dataset = {int(devdata)}
; empty: derived from multi_scale_max, so the pinned size packs 512² canvases at 416
canvas =
[train]
multi_scale_min = {size}
multi_scale_max = {size}
[summary]
scalar = 1000000
histogram = 1000000
image = 1000000
[save]
interval = 1e9
keep = 1
""")
    return path


def bench_e2e(batch: int, iters: int, devdata: bool = False, decomp: bool = False,
              n_images: int = 256, size: int = 416, device=None, model_ini=()) -> float:
    """End-to-end train images/s through the train CLI's parts: synthetic
    VOC (``data/synth.py::generate_voc``, seed 11) → ``cli/cache.py`` →
    ``cli/train.py::Train`` (Darknet-19 from ``config.ini``, pinned to
    ``size``) → its prewarm → one epoch + 2 steps of warm-up (the first pass
    fills the decoded-canvas cache) → ``iters`` timed steps.  Batches come
    from ``Train.device_batches``, as in the CLI's loop: the device-resident
    dataset (``devdata``) or the loader's host batches copied a step ahead.

    ``decomp`` serialises each phase with a synchronize and prints
    ``bench.py``'s stderr line: host prep, copy (the device dataset's gather
    with ``devdata``) and step ms per batch.  ``n_images``, ``size`` and
    ``model_ini`` (config files read after ``config.ini``, e.g.
    ``config/tiny.ini``) exist to run it small.  The workspace is a
    temporary directory, removed on exit.  Without OpenCV it raises
    ``SystemExit``: the synthetic images, up to 560 px, are downscaled to
    the 512² canvas with cv2."""
    from ..cli.cache import main as cache_main
    from ..cli.train import BATCH_KEYS, Train
    from ..config import load_config
    from ..data.synth import CLASSES, generate_voc

    _require_cv2("e2e", "its canvases downscale through cv2")
    device = _resolve(device)
    root = tempfile.mkdtemp(prefix="bench_e2e")
    try:
        with contextlib.redirect_stdout(sys.stderr):    # stdout holds the one JSON line
            voc = generate_voc(root, n_images, seed=11)
        category = os.path.join(root, "category")
        with open(category, "w") as f:
            f.write("\n".join(CLASSES))
        cfg_files = [str(REPO / "config.ini"), *map(str, model_ini),
                     _e2e_overlay(root, voc, category, batch, size, devdata)]
        if cache_main(["-c", *cfg_files]) != 0:
            raise SystemExit("bench e2e: cache step failed")
        args = argparse.Namespace(batch=None, finetune=None, resume=False, freeze=None,
                                  epochs=1, device=str(device))
        t = Train(args, load_config(cfg_files, ()))
        t.prewarm()
        warm = -(-n_images // batch) + 2
        phases = np.zeros(3)  # host, copy, step (seconds)
        t0 = None
        it = 0
        # the train CLI's own batch source; decomp copies host batches itself
        # so that the copy is a phase of its own
        source = iter(t.loader) if decomp and not devdata else t.device_batches()
        t_host0 = time.perf_counter()
        for b in source:
            t_host = time.perf_counter()
            t.step = it               # this step's augmentation draws, as the CLI's
            draws = t.draws(t.batch_size)
            if decomp and not devdata:
                dev = {k: torch.from_numpy(np.ascontiguousarray(b[k])).to(device)
                       for k in BATCH_KEYS}
            else:
                dev = b
            if decomp and t0 is not None:
                sync(device)          # the copy (or the on-device gather) has landed
            t_put = time.perf_counter()
            t.params, t.state, t.opt_state, metrics = t.train_step(
                t.params, t.state, t.opt_state, dev, 0, draws, size)
            if decomp and t0 is not None:
                sync(device)
            t_step = time.perf_counter()
            if t0 is not None:
                phases += (t_host - t_host0, t_put - t_host, t_step - t_put)
            it += 1
            if it == warm:
                float(metrics["total"])
                sync(device)
                t0 = time.perf_counter()
            elif it == warm + iters:
                break
            t_host0 = time.perf_counter()
        float(metrics["total"])
        sync(device)
        rate = iters * batch / (time.perf_counter() - t0)
        if decomp:
            ms = phases / iters * 1000
            cv = t.loader.dataset.canvas
            batch_mb = batch * (cv * cv * 3 + 4 * 10 * 9 + 16) / 1e6
            print(json.dumps({
                "e2e_decomposition_ms_per_batch": {
                    "host_prep": round(ms[0], 1), "transfer": round(ms[1], 1),
                    "device_step": round(ms[2], 1)},
                "batch": batch,
                "canvas": cv,
                "device_only_img_per_s": round(batch / ms[2] * 1000, 1),
                # the host→device copy rate of the loader's batches
                # (pageable memory, one copy a tensor), not a network's
                "tunnel_wire_MB_per_s": (None if devdata else
                                         round(batch_mb / ms[1] * 1000, 1)),
                "device_dataset": devdata,
                "note": "headline is the SERIALIZED end-to-end rate (phase "
                        "sum); device_only_img_per_s is the pipelining "
                        "headroom"},
            ), file=sys.stderr, flush=True)
        return rate
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_pipeline(batch: int, iters: int, n_images: int = 256) -> float:
    """Host input pipeline images/s: ``n_images`` random JPEGs of 300–500 px
    (written with OpenCV) → ``Dataset(canvas=672, max_boxes=60)`` →
    ``Loader`` on ``os.cpu_count()`` threads, ``iters`` batches after one.
    Without OpenCV it raises ``SystemExit``: another decoder would time
    another workload."""
    cv2 = _require_cv2("pipeline", "the mode times cv2's JPEG decode")
    from ..data.cache import make_record
    from ..data.dataset import Dataset
    from ..data.loader import Loader

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="bench_pipe")
    try:
        records = []
        for i in range(n_images):
            h, w = int(rng.integers(300, 500)), int(rng.integers(300, 500))
            img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            path = os.path.join(tmp, f"{i}.jpg")
            cv2.imwrite(path, img)
            records.append(make_record(path, [[0.1, 0.1]], [[0.5, 0.5]], [0]))
        dataset = Dataset(records, canvas=672, max_boxes=60)
        it = iter(Loader(dataset, batch, workers=os.cpu_count() or 4))
        next(it)  # warm the pool
        t0 = time.perf_counter()
        for _ in range(iters):
            next(it)
        return batch * iters / (time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> None:
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    iters = int(os.environ.get("BENCH_ITERS", "30"))
    mode = os.environ.get("BENCH_MODE", "infer")
    which = os.environ.get("BENCH_MODEL", "darknet")
    size = int(os.environ.get("BENCH_SIZE", "416"))
    if which != "darknet" and mode not in ("infer", "train", "latency"):
        # e2e and pipeline build their model from config.ini and would
        # measure Darknet-19 under another model's name
        raise SystemExit(f"BENCH_MODEL={which} is not honored by BENCH_MODE={mode}")
    if size != 416 and mode not in ("infer", "train", "latency"):
        raise SystemExit(f"BENCH_SIZE={size} is not honored by BENCH_MODE={mode}")
    device = bench_device()
    model_tag = "" if which == "darknet" else f"_{which}"
    baseline = BASELINE_FPS_BY_SIZE.get(size, BASELINE_FPS)
    if mode == "latency":
        ms = bench_latency(batch, iters, size, device)
        print(json.dumps({
            "metric": f"yolov2{model_tag}_{size}_detect_latency_ms",
            "value": round(ms, 3),
            "unit": "ms",
            # the paper's frame time at this size (1000/FPS); > 1 is faster
            "vs_baseline": round((1000.0 / baseline) / ms, 3),
            "device": card(device),
        }), flush=True)
        return
    devdata = bool(int(os.environ.get("BENCH_E2E_DEVDATA", "0") or 0))
    decomp = bool(int(os.environ.get("BENCH_E2E_DECOMP", "0") or 0))
    runs = {"infer": lambda: bench_infer(batch, iters, size, device),
            "train": lambda: bench_train(batch, iters, size, device),
            "e2e": lambda: bench_e2e(batch, iters, devdata, decomp, device=device),
            "pipeline": lambda: bench_pipeline(batch, iters)}
    rate = runs[mode]()
    mode_tag = "e2e_devdata" if mode == "e2e" and devdata else mode
    print(json.dumps({
        "metric": f"yolov2{model_tag}_{size}_{mode_tag}_images_per_sec_per_chip",
        "value": round(rate, 2),
        "unit": "images/sec",
        "vs_baseline": round(rate / baseline, 3),
        "device": card(device),
    }), flush=True)


if __name__ == "__main__":
    main()
