#!/usr/bin/env python
"""Smoke run of the PyTorch / CUDA port (``yolojax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # device, build, then a torch.profiler
                                       # breakdown of MobileNet detect at batch 128

Phases, each of which passes or raises (any failure exits non-zero):

1. device — a CUDA device must be present; prints its name and
   ``nvidia-smi``'s name and power limit;
2. build — compiles the three kernels of ``yolojax_torch/csrc`` at once, one
   ``nvcc`` each, and prints each one's registers and spills;
3. kernels against their plain versions on the card:
   * fused decode+NMS — raw heads from numpy seeds, f32 and bf16, four
     geometries, bench and saturated densities: ``keep`` and pick order
     identical, conf rtol 1e-5 (2e-5 at C=80), corners atol 1e-5;
   * dwconv3x3 and dwsep — MobileNet-416's routed shapes at batch 8, an odd
     spatial size and channel counts that are not multiples of 128, f32 and
     bf16, stride 1 and 2: f32 rtol/atol 1e-4 (the JAX tests' bound), bf16
     rtol/atol 1e-2 (about one bf16 ulp: the plain version sums in cuDNN's
     order); prints the share of output elements that are not bit-identical;
4. Darknet main path — full-width Darknet-19 at 416, VOC classes and anchors,
   bf16, built from ``config.ini`` with a seeded fresh init (objectness bias
   −6, the bench density), through ``Inference.detect_fn(0.005, 0.45, 100)``
   on batches of 8; the fused kernel's launch counter must have moved once
   per batch, the outputs must be finite and ``keep`` must match the plain
   postprocess of the same raw head; then ``cli.detect.detect_image`` on one
   seeded 480×640 image;
5. MobileNet main path — full-width MobileNet-YOLOv2 at 416 from
   ``config.ini`` + ``config/mobilenet.ini`` with ``pallas = nms fusedpost
   dwsep dwconv``, the same seeded init and density, batches of 8 through
   ``detect_fn``: dwconv launched 4 times, dwsep 7 times and the fused kernel
   once per batch; finite outputs, ``keep`` as the plain postprocess; the
   raw head against the same forward without ``dwsep dwconv`` (cuDNN): f32
   rtol/atol 1e-3 with TF32 off, bf16 mean abs diff ≤ 1 % of mean |raw|;
   one more batch with the objectness bias at 0, where the random head has
   picks, against the plain postprocess; then ``detect_image``;
6. times (Darknet's right after phase 4, MobileNet's after phase 5) — CUDA
   events, warm-up, median of 7 (or of 8 taken in turns): the fused kernel
   against its plain version on Darknet's raw heads, each routed depthwise
   layer shape against its plain version, and detect images/s of Darknet and
   of MobileNet with and without its kernels, at batch 8 and 128.

Prints a ``{"kernels": [...]}`` JSON line, then, last, ``{"ok": true, "device":
{...}}``.  Times are information, not a benchmark.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
THRESHOLD, OVERLAP, TOPK = 0.005, 0.45, 100
BENCH_OBJECTNESS = -6.0     # background-dominated scores, as bench.py sets them
# (B, H, W, A, C): VOC at 416 and 608, COCO's 80 classes, an odd tiny grid
GEOMETRIES = [(8, 13, 13, 5, 20), (8, 19, 19, 5, 20), (2, 13, 13, 5, 80), (1, 4, 3, 2, 3)]
REPS = 7
SIZE = 416                  # input size of both models, config.ini's [data] sizes
MOBILENET_TOKENS = "nms fusedpost dwsep dwconv"
# MobileNet-416's routed layers, per forward: (count, H, C, Cout, stride)
DWCONV_LAYERS = [(1, 104, 128, 128, 1), (1, 104, 128, 128, 2), (1, 52, 256, 256, 1),
                 (1, 52, 256, 256, 2)]
DWSEP_LAYERS = [(5, 26, 512, 512, 1), (1, 26, 512, 1024, 2), (1, 13, 1024, 1024, 1)]
# kernel launches per detect_fn batch on each main path
DARKNET_LAUNCHES = {"postprocess_fused": 1, "dwconv3x3": 0, "dwsep": 0}
MOBILENET_LAUNCHES = {"postprocess_fused": 1, "dwconv3x3": 4, "dwsep": 7}
# kernel-vs-plain cases beyond the routed shapes: odd spatial sizes, C % 128 != 0
DWCONV_EXTRA = [(8, 27, 128, 128, 2), (8, 13, 1024, 1024, 2), (2, 13, 72, 72, 1),
                (2, 13, 36, 36, 2)]
DWSEP_EXTRA = [(8, 27, 64, 96, 2), (8, 13, 512, 1024, 2), (2, 13, 72, 40, 1)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


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
    from yolojax_torch.kernels import _build, dwconv, dwsep, postprocess_fused

    t0 = time.perf_counter()
    libs = _build.build_all([postprocess_fused.SOURCE, dwconv.SOURCE, dwsep.SOURCE])
    log(f"[build] {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s "
        "(in parallel)")
    for lib in libs:
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] ptxas {lib.name.split('-')[0]}: {line.strip()}")


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


def fused_vs_plain() -> float:
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
                log(f"[kernel] fused {what}: match, {int(want.keep.sum())} picks, "
                    f"max abs err {err:.3g}")
    log(f"[kernel] fused: {cases} cases match the plain version; max abs err {worst:.3g}")
    return worst


def dw_inputs(rng, b, h, c, cout, dtype):
    """Seeded (x, taps, bd, wp, bp) on the card; He-scaled weights."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    x = f(rng.standard_normal((b, h, h, c))).to(dtype)
    wd = f(rng.standard_normal((3, 3, c)) * np.sqrt(2 / 9)).to(dtype)
    wp = f(rng.standard_normal((c, cout)) * np.sqrt(2 / c)).to(dtype)
    return x, wd, f(rng.normal(0, 0.1, c)), wp, f(rng.normal(0, 0.1, cout))


def dw_vs_plain() -> dict:
    """dwconv3x3 and dwsep against their plain versions; worst abs err each."""
    from yolojax_torch.kernels.dwconv import dwconv3x3, dwconv3x3_plain
    from yolojax_torch.kernels.dwsep import dwsep, dwsep_plain

    rng = np.random.default_rng(4)
    worst = {"dwconv3x3": 0.0, "dwsep": 0.0}
    cases = [("dwconv3x3", 8, *layer[1:]) for layer in DWCONV_LAYERS]
    cases += [("dwconv3x3", *case) for case in DWCONV_EXTRA]
    cases += [("dwsep", 8, *layer[1:]) for layer in DWSEP_LAYERS]
    cases += [("dwsep", *case) for case in DWSEP_EXTRA]
    for name, b, h, c, cout, stride in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, wd, bd, wp, bp = dw_inputs(rng, b, h, c, cout, dtype)
            if name == "dwconv3x3":
                got, want = dwconv3x3(x, wd, bd, stride), dwconv3x3_plain(x, wd, bd, stride)
            else:
                got, want = (dwsep(x, wd, bd, wp, bp, stride),
                             dwsep_plain(x, wd, bd, wp, bp, stride))
            torch.cuda.synchronize()
            what = f"{name} {(b, h, h, c)}->{tuple(want.shape)} s{stride} {str(dtype)[6:]}"
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{what}: kernel gave {tuple(got.shape)} {got.dtype}")
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"{what}: {m}")
            err = (got.float() - want.float()).abs().max().item()
            differ = (got != want).float().mean().item()
            worst[name] = max(worst[name], err)
            log(f"[kernel] {what}: match, max abs err {err:.3g}, "
                f"{100 * differ:.4f} % of elements not bit-identical")
    log(f"[kernel] depthwise: {2 * len(cases)} cases match the plain versions; "
        f"max abs err {worst}")
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


def in_turns(plain, kernel) -> tuple[float, float]:
    """Medians of (plain, kernel) timed in turns on one card: plain, kernel,
    kernel, plain."""
    half = REPS // 2 + 1
    t_plain = cuda_ms(plain, half)
    t_kernel = cuda_ms(kernel, half) + cuda_ms(kernel, half)
    t_plain += cuda_ms(plain, half)
    return float(np.median(t_plain)), float(np.median(t_kernel))


def launch_counters():
    from yolojax_torch.kernels.dwconv import dwconv3x3
    from yolojax_torch.kernels.dwsep import dwsep
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused

    return {"postprocess_fused": postprocess_fused, "dwconv3x3": dwconv3x3, "dwsep": dwsep}


def drive(config, what: str, expect: dict):
    """Drive ``detect_fn`` on seeded batches of 8 at the configured size, with
    every launch counter set to 0 just before and read just after; check the
    counts, the outputs and the plain postprocess of the same raw heads, then
    ``detect_image``.  Returns (model, params, state, folded, run, launches)."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.detect import detect_image
    from yolojax_torch.models.inference import Inference
    from yolojax_torch.ops.postprocess import postprocess_raw

    category, anchors, model = build(config)
    size = int(config.get("data", "sizes").split(",")[0])
    params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
    params["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = BENCH_OBJECTNESS
    inference = Inference(model)
    folded = inference.fold(params, state)
    run = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
    n_params = sum(lp["w"].numel() + lp["b"].numel() for lp in folded.values())
    log(f"[{what}] {type(model).__name__} {size}x{size}, {len(category)} classes, "
        f"{len(anchors)} anchors, {model.dtype}, kernels {sorted(model.pallas)}, "
        f"{n_params} folded params")

    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.uniform(0, 1, (8, size, size, 3)).astype(np.float32))
               .to("cuda") for _ in range(3)]
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = [run(folded, x) for x in batches]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: per_batch * len(batches) for name, per_batch in expect.items()}
    if launches != want:
        raise AssertionError(f"{what}: {len(batches)} batches launched {launches}, "
                             f"expected {want}")
    anchors_t = torch.as_tensor(anchors, device="cuda")
    with torch.inference_mode():
        for i, (x, out) in enumerate(zip(batches, outs)):
            shape = (8, model.num_classes, TOPK)
            if out.conf.shape != shape or out.yx_min.shape != (*shape, 2):
                raise AssertionError(f"{what} batch {i}: output shape {tuple(out.conf.shape)}")
            if not all(bool(torch.isfinite(t).all()) for t in (out.yx_min, out.yx_max, out.conf)):
                raise AssertionError(f"{what} batch {i}: non-finite outputs")
            raw = model.apply_folded(folded, x)
            plain = postprocess_raw(raw, anchors_t, THRESHOLD, OVERLAP, TOPK)
            compare(out, plain, model.num_classes, f"{what} batch {i}")
            picks = out.keep.sum(-1).float()
            log(f"[{what}] batch {i}: raw {tuple(raw.shape)} {raw.dtype}, keep matches the "
                f"plain postprocess; picks per (image, class) mean {picks.mean().item():.2f} "
                f"max {int(picks.max().item())}")
    log(f"[{what}] detect_fn ran {len(batches)} batches; launches {launches}")

    image = np.random.default_rng(2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    ymin, ymax, cls, conf = detect_image(config, model, params, state, image, size)
    if not (ymin.shape == ymax.shape == (len(cls), 2) and len(conf) == len(cls)
            and np.isfinite(conf).all()):
        raise AssertionError(f"{what}: detect_image returned malformed detections")
    log(f"[{what}] detect_image on a 480x640 image returned {len(cls)} detections "
        f"(threshold {config.getfloat('detect', 'threshold')})")
    return model, params, state, folded, run, launches


def darknet_path():
    from yolojax_torch.config import load_config

    config = load_config(None)      # the repo's config.ini: Darknet-19, VOC, bf16, fusedpost
    return drive(config, "darknet", DARKNET_LAUNCHES)


def mobilenet_config(tokens: str = MOBILENET_TOKENS, dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    return load_config([str(ROOT / "config.ini"), str(ROOT / "config" / "mobilenet.ini")],
                       [f"model/pallas={tokens}", f"model/dtype={dtype}"])


def without_dw_kernels(model):
    """The same model with ``dwsep dwconv`` removed: the cuDNN path, which
    runs on the same folded weights (it reads only their ``w`` and ``b``)."""
    import dataclasses

    return dataclasses.replace(model, pallas=model.pallas - {"dwsep", "dwconv"})


def mobilenet_path():
    from yolojax_torch.cli.common import build, load_weights_auto

    model, params, state, folded, run, launches = drive(
        mobilenet_config(), "mobilenet", MOBILENET_LAUNCHES)
    # at the bench density this random head leaves every score under the
    # threshold; hold the kernels' detections to the plain postprocess where
    # there are picks too: objectness bias 0 on one more batch
    from yolojax_torch.ops.postprocess import postprocess_raw

    dense = dict(folded, out=dict(folded["out"], b=folded["out"]["b"].clone()))
    dense["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = 0.0
    x = torch.from_numpy(np.random.default_rng(7).uniform(0, 1, (8, SIZE, SIZE, 3))
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        out = run(dense, x)
        plain = postprocess_raw(model.apply_folded(dense, x),
                                torch.as_tensor(model.anchors, device="cuda"),
                                THRESHOLD, OVERLAP, TOPK)
        compare(out, plain, model.num_classes, "mobilenet dense batch")
    picks = out.keep.sum(-1).float()
    if not picks.max() > 0:
        raise AssertionError("mobilenet dense batch: no picks to compare")
    log(f"[mobilenet] dense batch (objectness bias 0): keep matches the plain postprocess; "
        f"picks per (image, class) mean {picks.mean().item():.2f} max {int(picks.max().item())}")
    # the raw head against the cuDNN path on the same weights and images
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (8, SIZE, SIZE, 3))
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        got = model.apply_folded(folded, x).float()
        want = without_dw_kernels(model).apply_folded(folded, x).float()
        diff = (got - want).abs()
        ratio = diff.mean().item() / want.abs().mean().item()
        log(f"[mobilenet] bf16 raw head vs cuDNN path: max abs diff {diff.max().item():.4g}, "
            f"mean abs diff {diff.mean().item():.4g} = {100 * ratio:.3f} % of mean |raw| "
            f"{want.abs().mean().item():.4g}")
        if not (ratio <= 0.01 and torch.isfinite(got).all()):
            raise AssertionError(f"mobilenet bf16: mean abs diff {100 * ratio:.3f} % > 1 %")

        _, _, model32 = build(mobilenet_config(dtype="float32"))
        params32, state32, _ = load_weights_auto(mobilenet_config(dtype="float32"), model32,
                                                 rng_seed=0, device="cuda")
        folded32 = model32.fold(params32, state32)
        got = model32.apply_folded(folded32, x)
        want = without_dw_kernels(model32).apply_folded(folded32, x)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3,
                                   msg=lambda m: f"mobilenet f32 raw head vs cuDNN: {m}")
        log(f"[mobilenet] f32 raw head vs cuDNN path (TF32 off): max abs diff "
            f"{(got - want).abs().max().item():.4g} within rtol/atol 1e-3")
    return model, folded, run, launches


def darknet_times(model, folded, run, card: str) -> dict:
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.postprocess import postprocess_raw

    anchors = torch.as_tensor(model.anchors, device="cuda")
    rng = np.random.default_rng(3)
    result = {}
    with torch.inference_mode():
        for b in (8, 128):
            x = torch.from_numpy(rng.uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)).cuda()
            raw = model.apply_folded(folded, x)
            t_plain, t_kernel = in_turns(
                lambda: postprocess_raw(raw, anchors, THRESHOLD, OVERLAP, TOPK),
                lambda: postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK))
            t_fwd = float(np.median(cuda_ms(lambda: model.apply_folded(folded, x))))
            t_detect = cuda_ms(lambda: run(folded, x))
            med = float(np.median(t_detect))
            result[b] = {"kernel_ms": t_kernel, "plain_ms": t_plain, "forward_ms": t_fwd,
                         "detect_ms": med, "img_per_s": b / (med / 1e3)}
            log(f"[time] {card} | raw {tuple(raw.shape)} {raw.dtype}: fused kernel "
                f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms (median of 8 / 8)")
            log(f"[time] {card} | Darknet detect batch {b} at {SIZE}: {med:.3f} ms = "
                f"{result[b]['img_per_s']:.1f} img/s (forward alone {t_fwd:.3f} ms; "
                f"median of {REPS}); all runs {[round(t, 3) for t in t_detect]}")
    return result


def dw_times(card: str) -> dict:
    """Each routed layer shape, kernel against plain version, bf16; returns
    per batch the sums over one forward's routed layers."""
    from yolojax_torch.kernels.dwconv import dwconv3x3, dwconv3x3_plain
    from yolojax_torch.kernels.dwsep import dwsep, dwsep_plain

    rng = np.random.default_rng(6)
    sums = {}
    for b in (8, 128):
        for name, layers in (("dwconv3x3", DWCONV_LAYERS), ("dwsep", DWSEP_LAYERS)):
            total_k = total_p = 0.0
            for count, h, c, cout, stride in layers:
                x, wd, bd, wp, bp = dw_inputs(rng, b, h, c, cout, torch.bfloat16)
                if name == "dwconv3x3":
                    plain = lambda: dwconv3x3_plain(x, wd, bd, stride)
                    kernel = lambda: dwconv3x3(x, wd, bd, stride)
                else:
                    plain = lambda: dwsep_plain(x, wd, bd, wp, bp, stride)
                    kernel = lambda: dwsep(x, wd, bd, wp, bp, stride)
                t_plain, t_kernel = in_turns(plain, kernel)
                total_k, total_p = total_k + count * t_kernel, total_p + count * t_plain
                log(f"[time] {card} | {name} ({b},{h},{h},{c})->{cout} s{stride} bf16: kernel "
                    f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms (median of 8 / 8; "
                    f"{count}x per forward)")
            sums[(name, b)] = (total_k, total_p)
            log(f"[time] {card} | {name} per MobileNet-416 forward at batch {b}: kernel "
                f"{total_k:.4f} ms, plain {total_p:.4f} ms")
    return sums


def mobilenet_times(model, folded, run, card: str) -> dict:
    from yolojax_torch.models.inference import Inference

    plain_run = Inference(without_dw_kernels(model)).detect_fn(THRESHOLD, OVERLAP, TOPK)
    rng = np.random.default_rng(3)
    result = {}
    for b in (8, 128):
        x = torch.from_numpy(rng.uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)).cuda()
        t_plain, t_kernel = in_turns(lambda: plain_run(folded, x), lambda: run(folded, x))
        result[b] = {"detect_ms": t_kernel, "img_per_s": b / (t_kernel / 1e3),
                     "plain_detect_ms": t_plain, "plain_img_per_s": b / (t_plain / 1e3)}
        log(f"[time] {card} | MobileNet detect batch {b} at {SIZE}: with dwsep+dwconv "
            f"{t_kernel:.3f} ms = {result[b]['img_per_s']:.1f} img/s; cuDNN path "
            f"{t_plain:.3f} ms = {result[b]['plain_img_per_s']:.1f} img/s (median of 8 / 8)")
    return result


def profile(card: str) -> None:
    """torch.profiler over 5 MobileNet detect calls at batch 128, with the
    dw kernels and on the cuDNN path: device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.models.inference import Inference

    config = mobilenet_config()
    _, _, model = build(config)
    params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
    params["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = BENCH_OBJECTNESS
    folded = model.fold(params, state)
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (128, SIZE, SIZE, 3))
                         .astype(np.float32)).cuda()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):  # start-up
        Inference(model).detect_fn(THRESHOLD, OVERLAP, TOPK)(folded, x)
        torch.cuda.synchronize()
    for what, m in (("dwsep+dwconv", model), ("cuDNN path", without_dw_kernels(model))):
        run = Inference(m).detect_fn(THRESHOLD, OVERLAP, TOPK)
        for _ in range(3):
            run(folded, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run(folded, x)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5 * 1e3
        # device kernels only: an aten op's row repeats its kernels' device time
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels) / 5
        if device_us <= 0:
            raise AssertionError("torch.profiler recorded no device time; time with CUDA "
                                 "events instead")
        log(f"[profile] {card} | MobileNet detect batch 128, {what}: {device_us / 1e3:.3f} ms "
            f"of device time per call, {wall:.3f} ms wall under the profiler, "
            f"{sum(e.count for e in kernels) / 5:.0f} kernel launches per call")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:16]:
            share = 100 * e.self_device_time_total / 5 / device_us
            log(f"[profile]   {share:6.2f} %  {e.self_device_time_total / 5 / 1e3:8.3f} ms  "
                f"x{e.count / 5:<5.0f} {e.key[:100]}")


def main() -> None:
    name, card = check_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_kernels()
    if sys.argv[1:] == ["--profile"]:
        profile(card)
        return
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]}; see --help in the source")
    fused_err = fused_vs_plain()
    dw_err = dw_vs_plain()
    # each model's times right after its path, so Darknet's stay comparable
    # with runs that drive Darknet alone
    dark_model, _, _, dark_folded, dark_run, dark_launches = darknet_path()
    dark_t = darknet_times(dark_model, dark_folded, dark_run, card)
    del dark_model, dark_folded, dark_run
    mob_model, mob_folded, mob_run, mob_launches = mobilenet_path()
    dw_t = dw_times(card)
    mobilenet_times(mob_model, mob_folded, mob_run, card)
    # launches: from the main paths' runs (Darknet's and MobileNet's, 3 batches
    # each); ms / plain_ms: batch 8 (fused: on Darknet's raw head; dwconv3x3 and
    # dwsep: summed over one MobileNet-416 forward's routed layers)
    print(json.dumps({"kernels": [
        {"name": "postprocess_fused", "route": "cuda",
         "source": "yolojax_torch/csrc/postprocess_fused.cu",
         "replaces": "yolojax/kernels/nms.py:247",
         "launches": dark_launches["postprocess_fused"] + mob_launches["postprocess_fused"],
         "max_abs_err": fused_err, "ms": dark_t[8]["kernel_ms"], "plain_ms": dark_t[8]["plain_ms"]},
        {"name": "dwconv3x3", "route": "cuda", "source": "yolojax_torch/csrc/dwconv3x3.cu",
         "replaces": "yolojax/kernels/dwconv.py:65", "launches": mob_launches["dwconv3x3"],
         "max_abs_err": dw_err["dwconv3x3"], "ms": dw_t[("dwconv3x3", 8)][0],
         "plain_ms": dw_t[("dwconv3x3", 8)][1]},
        {"name": "dwsep", "route": "cuda", "source": "yolojax_torch/csrc/dwsep.cu",
         "replaces": "yolojax/kernels/dwsep.py:104", "launches": mob_launches["dwsep"],
         "max_abs_err": dw_err["dwsep"], "ms": dw_t[("dwsep", 8)][0],
         "plain_ms": dw_t[("dwsep", 8)][1]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
