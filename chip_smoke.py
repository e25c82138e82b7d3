#!/usr/bin/env python
"""Smoke run of the PyTorch / CUDA port (``yolojax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which passes or raises (any failure exits non-zero):

1. device — a CUDA device must be present; prints its name and
   ``nvidia-smi``'s name and power limit;
2. build — compiles the fused decode+NMS kernel from ``yolojax_torch/csrc``;
3. kernel against its plain version on the card — raw heads from numpy
   seeds, f32 and bf16, four geometries, bench and saturated densities:
   ``keep`` and pick order identical, conf rtol 1e-5 (2e-5 at C=80),
   corners atol 1e-5;
4. main path — full-width Darknet-19 at 416, VOC classes and anchors, bf16,
   built from ``config.ini`` with a seeded fresh init (objectness bias −6,
   the bench density), through ``Inference.detect_fn(0.005, 0.45, 100)`` on
   batches of 8; the kernel's launch counter must have moved, the outputs
   must be finite and ``keep`` must match the plain postprocess of the same
   raw head; then ``cli.detect.detect_image`` on one seeded 480×640 image;
5. times — CUDA events, warm-up, median of 7: kernel and plain version on
   the main path's raw heads at batch 8 and 128, detect images/s at batch 8
   and 128.

Prints a ``{"kernels": [...]}`` JSON line, then, last, ``{"ok": true, "device":
{...}}``.  Times are information, not a benchmark.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

THRESHOLD, OVERLAP, TOPK = 0.005, 0.45, 100
BENCH_OBJECTNESS = -6.0     # background-dominated scores, as bench.py sets them
# (B, H, W, A, C): VOC at 416 and 608, COCO's 80 classes, an odd tiny grid
GEOMETRIES = [(8, 13, 13, 5, 20), (8, 19, 19, 5, 20), (2, 13, 13, 5, 80), (1, 4, 3, 2, 3)]
REPS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def check_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    log(f"[device] torch: {name}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi name, power.limit: {card}")
    return name, card


def build_kernels() -> None:
    from yolojax_torch.kernels import postprocess_fused as pf

    t0 = time.perf_counter()
    lib = pf.build()
    log(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")
    report = lib.with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")


def compare(got, want, c: int, what: str) -> float:
    """Kept slots identical in order; returns the largest abs difference."""
    keep = want.keep.cpu().numpy()
    if not np.array_equal(got.keep.cpu().numpy(), keep):
        raise AssertionError(f"{what}: keep differs "
                             f"({int(got.keep.sum())} kept vs {int(keep.sum())} plain)")
    conf_got, conf_want = (np.where(keep, t.conf.cpu().numpy(), 0) for t in (got, want))
    np.testing.assert_allclose(conf_got, conf_want, rtol=2e-5 if c == 80 else 1e-5, atol=0,
                               err_msg=f"{what}: conf")
    err = float(np.abs(conf_got - conf_want).max(initial=0.0))
    for name in ("yx_min", "yx_max"):
        g, w = (np.where(keep[..., None], getattr(t, name).cpu().numpy(), 0) for t in (got, want))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=f"{what}: {name}")
        err = max(err, float(np.abs(g - w).max(initial=0.0)))
    return err


def kernel_vs_plain() -> float:
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.postprocess import postprocess_raw

    rng = np.random.default_rng(0)
    worst, cases = 0.0, 0
    for b, h, w, a, c in GEOMETRIES:
        anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
        for density in ("bench", "saturated"):
            raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 2).astype(np.float32)
            if density == "bench":
                obj = raw.reshape(b, h, w, a, 5 + c)[..., 4]
                obj[...] = BENCH_OBJECTNESS + 0.5 * obj
            for dtype in (torch.float32, torch.bfloat16):
                head = torch.from_numpy(raw).to("cuda", dtype)
                got = postprocess_fused(head, anchors, THRESHOLD, OVERLAP, TOPK)
                want = postprocess_raw(head, anchors, THRESHOLD, OVERLAP, TOPK)
                torch.cuda.synchronize()
                what = f"({b},{h},{w},{a * (5 + c)}) {density} {str(dtype)[6:]}"
                err = compare(got, want, c, what)
                worst, cases = max(worst, err), cases + 1
                log(f"[kernel] {what}: match, {int(want.keep.sum())} picks, "
                    f"max abs err {err:.3g}")
    log(f"[kernel] {cases} cases match the plain version; max abs err {worst:.3g}")
    return worst


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> list[float]:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def main_path():
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.detect import detect_image
    from yolojax_torch.config import load_config
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.models.inference import Inference
    from yolojax_torch.ops.postprocess import postprocess_raw

    config = load_config(None)      # the repo's config.ini: Darknet-19, VOC, bf16, fusedpost
    category, anchors, model = build(config)
    size = int(config.get("data", "sizes").split(",")[0])
    params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
    params["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = BENCH_OBJECTNESS
    inference = Inference(model)
    folded = inference.fold(params, state)
    run = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
    log(f"[main] {type(model).__name__} {size}x{size}, {len(category)} classes, "
        f"{len(anchors)} anchors, {model.dtype}, kernels {sorted(model.pallas)}, "
        f"{sum(v.numel() for lp in folded.values() for v in lp.values())} folded params")

    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.uniform(0, 1, (8, size, size, 3)).astype(np.float32))
               .to("cuda") for _ in range(3)]
    postprocess_fused.launches = 0
    outs = [run(folded, x) for x in batches]
    torch.cuda.synchronize()
    launches = postprocess_fused.launches
    if launches != len(batches):
        raise AssertionError(f"main path launched the kernel {launches} times for "
                             f"{len(batches)} batches")
    anchors_t = torch.as_tensor(anchors, device="cuda")
    with torch.inference_mode():
        for i, (x, out) in enumerate(zip(batches, outs)):
            shape = (8, model.num_classes, TOPK)
            if out.conf.shape != shape or out.yx_min.shape != (*shape, 2):
                raise AssertionError(f"batch {i}: output shape {tuple(out.conf.shape)}")
            if not all(bool(torch.isfinite(t).all()) for t in (out.yx_min, out.yx_max, out.conf)):
                raise AssertionError(f"batch {i}: non-finite outputs")
            raw = model.apply_folded(folded, x)
            plain = postprocess_raw(raw, anchors_t, THRESHOLD, OVERLAP, TOPK)
            compare(out, plain, model.num_classes, f"main batch {i}")
            picks = out.keep.sum(-1).float()
            log(f"[main] batch {i}: raw {tuple(raw.shape)} {raw.dtype}, keep matches the plain "
                f"postprocess; picks per (image, class) mean {picks.mean().item():.2f} "
                f"max {int(picks.max().item())}")
    log(f"[main] detect_fn ran {len(batches)} batches through the kernel "
        f"({launches} launches)")

    image = np.random.default_rng(2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    ymin, ymax, cls, conf = detect_image(config, model, params, state, image, size)
    if not (ymin.shape == ymax.shape == (len(cls), 2) and len(conf) == len(cls)
            and np.isfinite(conf).all()):
        raise AssertionError("detect_image returned malformed detections")
    log(f"[main] detect_image on a 480x640 image returned {len(cls)} detections "
        f"(threshold {config.getfloat('detect', 'threshold')})")
    return model, folded, run, launches


def times(model, folded, run, card: str) -> dict:
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.postprocess import postprocess_raw

    anchors = torch.as_tensor(model.anchors, device="cuda")
    rng = np.random.default_rng(3)
    result = {}
    with torch.inference_mode():
        for b in (8, 128):
            x = torch.from_numpy(rng.uniform(0, 1, (b, 416, 416, 3)).astype(np.float32)).cuda()
            raw = model.apply_folded(folded, x)
            kernel = lambda: postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
            plain = lambda: postprocess_raw(raw, anchors, THRESHOLD, OVERLAP, TOPK)
            # in turns on one card: plain, kernel, kernel, plain
            t_plain = cuda_ms(plain, REPS // 2 + 1)
            t_kernel = cuda_ms(kernel, REPS // 2 + 1) + cuda_ms(kernel, REPS // 2 + 1)
            t_plain += cuda_ms(plain, REPS // 2 + 1)
            t_fwd = cuda_ms(lambda: model.apply_folded(folded, x))
            t_detect = cuda_ms(lambda: run(folded, x))
            med = lambda t: float(np.median(t))
            result[b] = {"kernel_ms": med(t_kernel), "plain_ms": med(t_plain),
                         "forward_ms": med(t_fwd), "detect_ms": med(t_detect),
                         "img_per_s": b / (med(t_detect) / 1e3)}
            log(f"[time] {card} | raw {tuple(raw.shape)} {raw.dtype}: fused kernel "
                f"{med(t_kernel):.4f} ms, plain {med(t_plain):.4f} ms (median of "
                f"{len(t_kernel)} / {len(t_plain)})")
            log(f"[time] {card} | detect batch {b} at 416: {med(t_detect):.3f} ms = "
                f"{result[b]['img_per_s']:.1f} img/s (forward alone {med(t_fwd):.3f} ms; "
                f"median of {REPS}); all runs {[round(t, 3) for t in t_detect]}")
    return result


def main() -> None:
    name, card = check_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_kernels()
    max_err = kernel_vs_plain()
    model, folded, run, launches = main_path()
    t = times(model, folded, run, card)
    print(json.dumps({"kernels": [{
        "name": "postprocess_fused", "route": "cuda",
        "source": "yolojax_torch/csrc/postprocess_fused.cu",
        "replaces": "yolojax/kernels/nms.py:247",
        "launches": launches, "max_abs_err": max_err,
        "ms": t[8]["kernel_ms"], "plain_ms": t[8]["plain_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
