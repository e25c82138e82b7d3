#!/usr/bin/env python
"""Smoke run of the PyTorch / CUDA port (``yolojax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --profile    # device, build, then a torch.profiler
                                       # breakdown of MobileNet detect at batch 128

Phases, each of which passes or raises (any failure exits non-zero):

1. device — a CUDA device must be present; prints its name and
   ``nvidia-smi``'s name and power limit;
2. build — compiles the six kernels of ``yolojax_torch/csrc`` at once, one
   ``nvcc`` each, prints each one's registers and spills, and requires
   HGMMA (wgmma) in the SASS of dwsep's bf16 kernel (``cuobjdump``);
   then the host time of one ``maxpool2x2`` call at Tiny's batch-8 pool4
   shape, part by part (``time.perf_counter_ns``, median of 7 rounds of 300
   calls), beside ``F.max_pool2d``, and of one fused decode+NMS call;
3. kernels against their plain versions on the card:
   * fused decode+NMS — raw heads from numpy seeds, f32 and bf16, four
     geometries, bench and saturated densities: ``keep`` and pick order
     identical, conf rtol 1e-5 (2e-5 at C=80), corners atol 1e-5; prints
     the longest compacted row (candidates above the threshold) per case;
     then ``torch.profiler`` over one call must show one device kernel;
   * dwconv3x3 and dwsep — MobileNet-416's routed shapes at batch 8, an odd
     spatial size, channel counts that are not multiples of 128 (and, for
     dwsep, C = 36: element loads), a last pixel tile that is not full
     (3, 13, 13, 1024) and batch 128, f32 and bf16, stride 1 and 2: f32
     rtol/atol 1e-4 (the JAX tests' bound), bf16
     rtol/atol 1e-2 (about one bf16 ulp: the plain version sums in cuDNN's
     order); prints the share of output elements that are not bit-identical;
     dwconv3x3 must be bit-identical to its tap-order reference
     (``dwconv3x3_taps``, separate torch ops on the card), also where a row
     tile is cut by the image border (37 rows) and where a row takes two
     column tiles;
   * nms_select — the four geometries' decoded heads, bench and saturated
     densities, boxes broadcast over the classes and one box row per class,
     max_out 100 (and 300 at 19×19): idx, conf and valid identical; then the
     postprocess with its gather against the plain one;
   * maxpool2x2 and reorg_s2d — the five routed pool shapes at batch 8, c21's
     (8,26,26,64), C = 3 and 72 and 2×2 inputs, f32 and bf16: bit-identical;
4. Darknet main path — full-width Darknet-19 at 416, VOC classes and anchors,
   bf16, built from ``config.ini`` with a seeded fresh init (objectness bias
   −6, the bench density), through ``Inference.detect_fn(0.005, 0.45, 100)``
   on batches of 8; every launch counter is set to 0 just before and read
   just after, and must show one fused launch per batch and nothing else;
   the outputs must be finite and ``keep`` must match the plain postprocess
   of the same raw head; then ``cli.detect.detect_image`` on one seeded
   480×640 image;
5. MobileNet main path — full-width MobileNet-YOLOv2 at 416 from
   ``config.ini`` + ``config/mobilenet.ini`` with ``pallas = nms fusedpost
   dwsep dwconv``, the same seeded init, density and checks: dwconv 4,
   dwsep 7 and fused 1 launch per batch; one more batch with the objectness
   bias at 0, where the random head has picks, against the plain
   postprocess; the raw head against the same forward without ``dwsep
   dwconv`` (cuDNN): f32 rtol/atol 1e-3 with TF32 off, bf16 mean abs diff
   ≤ 1 % of mean |raw|; then ``detect_image``;
6. Darknet-s2d main path — Darknet-19 from ``config.ini`` with ``reorg =
   s2d`` and ``pallas = nms pool reorg``, the same init, density and
   checks: nms_select 1, maxpool2x2 3 and reorg_s2d 1 launch per batch; the
   dense batch; the raw head bit-identical to the same forward without
   ``pool reorg`` in f32 (TF32 off) and, where cuDNN allows, in bf16 (else
   within MobileNet's 1 % bound, said so); then ``detect_image``;
7. Tiny main path — Tiny-YOLO-VOC from ``config.ini`` + ``config/tiny.ini``
   with ``pallas = nms fusedpost pool``: maxpool2x2 2 and fused 1 launch per
   batch, a (B,13,13,125) raw head, the dense batch, the raw head against
   the forward without ``pool`` as for Darknet-s2d, ``detect_image``;
8. times (each model's right after its path) — CUDA events, warm-up, median
   of 7 (or of 8 taken in turns): each kernel against its plain version and,
   where one PyTorch call computes the TPU kernel's function, that call
   (``F.conv2d`` with groups for dwconv3x3, ``F.max_pool2d``), at batch 8
   and 128 (fused and nms_select on Darknet's raw and decoded heads, each
   routed depthwise and pool shape, the reorg at c21's shape), each beside
   its bound (bytes over 3.35 TB/s or operations over the peak of their
   type, from this run's inputs; dwsep's layers also as TFLOP/s), and detect
   images/s of each path, with and without its forward kernels.

Prints a ``{"kernels": [...]}`` JSON line (per kernel: launches on the main
paths, max abs err, ms, plain_ms, bound_ms, bound_by and library_ms at batch
8, null where no PyTorch call computes the function), then, last, ``{"ok":
true, "device": {...}}``.  Times are information, not a benchmark.
"""

from __future__ import annotations

import dataclasses
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
SIZE = 416                  # input size of every model, config.ini's [data] sizes
TIME_BATCHES = (8, 128)
MOBILENET_TOKENS = "nms fusedpost dwsep dwconv"
S2D_TOKENS = "nms pool reorg"
TINY_TOKENS = "nms fusedpost pool"
# MobileNet-416's routed layers, per forward: (count, H, C, Cout, stride)
DWCONV_LAYERS = [(1, 104, 128, 128, 1), (1, 104, 128, 128, 2), (1, 52, 256, 256, 1),
                 (1, 52, 256, 256, 2)]
DWSEP_LAYERS = [(5, 26, 512, 512, 1), (1, 26, 512, 1024, 2), (1, 13, 1024, 1024, 1)]
# routed pools per forward, (H, C) of the input: Darknet's pool3-pool5, Tiny's pool4-pool5
DARKNET_POOLS = [(104, 128), (52, 256), (26, 512)]
TINY_POOLS = [(52, 128), (26, 256)]
REORG_SHAPE = (26, 64)      # c21's output at 416: (B, 26, 26, 64) -> (B, 13, 13, 256)
KERNELS = ("postprocess_fused", "dwconv3x3", "dwsep", "nms_select", "maxpool2x2", "reorg_s2d")


def per_batch(**counts) -> dict:
    """Kernel launches per detect_fn batch: the named counts, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNELS}


# kernel launches per detect_fn batch on each main path
DARKNET_LAUNCHES = per_batch(postprocess_fused=1)
MOBILENET_LAUNCHES = per_batch(postprocess_fused=1, dwconv3x3=4, dwsep=7)
S2D_LAUNCHES = per_batch(nms_select=1, maxpool2x2=3, reorg_s2d=1)
TINY_LAUNCHES = per_batch(postprocess_fused=1, maxpool2x2=2)
# kernel-vs-plain cases beyond the routed shapes: odd spatial sizes, C % 128 != 0
# (2, 37, ...): the last 16-row tile of the 37 output rows holds 5; (1, 400, ...) and
# (1, 600, ...) walk each row in two column tiles
DWCONV_EXTRA = [(8, 27, 128, 128, 2), (8, 13, 1024, 1024, 2), (2, 13, 72, 72, 1),
                (2, 13, 36, 36, 2), (2, 37, 128, 128, 1), (1, 400, 32, 32, 1),
                (1, 600, 16, 16, 2)]
DWSEP_EXTRA = [(8, 27, 64, 96, 2), (8, 13, 512, 1024, 2), (2, 13, 72, 40, 1), (2, 13, 36, 40, 1),
               (3, 13, 1024, 1024, 1), (128, 26, 512, 512, 1)]
POOL_EXTRA = [(8, 26, 26, 72), (2, 2, 2, 128), (2, 2, 2, 72), (3, 6, 4, 3)]
REORG_EXTRA = [(2, 26, 26, 3), (2, 26, 26, 72), (2, 2, 2, 64), (2, 2, 2, 3)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# an H100 SXM's published peaks: device memory
# bytes/s, and flop/s by operand type (bf16 on the tensor cores, f32 on the
# CUDA cores)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16 tensor": 989e12, "f32": 67e12}
HOST_ROUNDS, HOST_CALLS = 7, 300   # host-time measurement: median of rounds of calls


def log(msg: str) -> None:
    print(msg, flush=True)


class Bound:
    """The least time the card could take for a sum of calls: per call the
    larger of its bytes over the memory rate and its operations over the
    peak rate of their type (types run on separate units, so the slowest
    type counts)."""

    def __init__(self):
        self.ms = {"bytes": 0.0, "operations": 0.0}

    def add(self, nbytes: float, flops: dict | None = None, count: int = 1) -> "Bound":
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = max((n / PEAK_FLOPS[kind] * 1e3 for kind, n in (flops or {}).items()),
                    default=0.0)
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.ms[by] += count * max(t_bytes, t_ops)
        return self

    @property
    def total(self) -> float:
        return self.ms["bytes"] + self.ms["operations"]

    @property
    def by(self) -> str:
        return max(self.ms, key=self.ms.get)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    from yolojax_torch.kernels import _build, dwconv, dwsep, nms, pool, postprocess_fused, reorg

    t0 = time.perf_counter()
    libs = _build.build_all([postprocess_fused.SOURCE, dwconv.SOURCE, dwsep.SOURCE, nms.SOURCE,
                             pool.SOURCE, reorg.SOURCE])
    log(f"[build] {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s "
        "(in parallel)")
    for lib in libs:
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"[build] ptxas {lib.name.split('-')[0]}: {line.strip()}")
    # the bf16 dwsep kernel must run its product on the tensor cores: wgmma is
    # HGMMA in the SASS
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        log(f"[build] no {cuobjdump}: the SASS of dwsep is not inspected")
        return
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(libs[2])], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    per_kernel, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif "HGMMA" in line and name:
            per_kernel[name] = per_kernel.get(name, 0) + 1
    log(f"[build] dwsep SASS: HGMMA instructions per function {per_kernel}")
    if not any("wgmma" in k for k in per_kernel):
        raise AssertionError("dwsep: the bf16 kernel's SASS has no HGMMA")


def compare(got, want, c: int, what: str, det=None) -> float:
    """Kept slots identical in order, conf to rtol 1e-5 (2e-5 at C=80),
    corners to atol 1e-5; returns the largest abs difference.

    With ``det``, the plain decode of the same raw head, a kept slot whose
    corners differ passes only as a near tie: the kernel's box must be a
    candidate of that image whose plain score for the class equals the plain
    pick's score to the conf tolerance.  The fused kernel's ``expf`` and
    PyTorch's sigmoid and softmax may round a saturated score an ulp apart,
    and the greedy loop then takes near-equal scores in another order."""
    keep = want.keep.cpu().numpy()
    if not np.array_equal(got.keep.cpu().numpy(), keep):
        raise AssertionError(f"{what}: keep differs "
                             f"({int(got.keep.sum())} kept vs {int(keep.sum())} plain)")
    rtol = 2e-5 if c == 80 else 1e-5
    conf_got, conf_want = (np.where(keep, t.conf.cpu().numpy(), 0) for t in (got, want))
    np.testing.assert_allclose(conf_got, conf_want, rtol=rtol, atol=0, err_msg=f"{what}: conf")
    err = float(np.abs(conf_got - conf_want).max(initial=0.0))
    corners = [(getattr(got, n).cpu().numpy(), getattr(want, n).cpu().numpy())
               for n in ("yx_min", "yx_max")]
    off = keep & np.any([(np.abs(g - w) > 1e-5).any(-1) for g, w in corners], axis=0)
    if off.any():
        if det is None:
            raise AssertionError(f"{what}: {int(off.sum())} kept slots pick other boxes")
        dmin, dmax, dconf = (t.float().cpu().numpy() for t in (det.yx_min, det.yx_max, det.conf))
        (gmin, _), (gmax, _) = corners
        for b, k, t in zip(*np.nonzero(off)):
            box = ((np.abs(dmin[b] - gmin[b, k, t]).max(-1) <= 1e-5)
                   & (np.abs(dmax[b] - gmax[b, k, t]).max(-1) <= 1e-5))
            pick = conf_want[b, k, t]
            if not (np.abs(dconf[b, box, k] - pick) <= rtol * pick).any():
                raise AssertionError(f"{what}: slot (image {b}, class {k}, {t}) picks a box that "
                                     "is no near tie of the plain pick")
        log(f"[tie] {what}: {int(off.sum())} of {int(keep.sum())} kept slots pick another "
            f"candidate whose plain score equals the plain pick's to rtol {rtol:g}")
    for g, w in corners:
        same = (keep & ~off)[..., None]
        err = max(err, float(np.abs(np.where(same, g - w, 0)).max(initial=0.0)))
    return err


def seeded_raw(rng, b, h, w, a, c, density: str) -> np.ndarray:
    """A raw head from numpy: normal logits, or (bench) objectness near −6."""
    raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 2).astype(np.float32)
    if density == "bench":
        obj = raw.reshape(b, h, w, a, 5 + c)[..., 4]
        obj[...] = BENCH_OBJECTNESS + 0.5 * obj
    return raw


def compacted(det) -> int:
    """The longest compacted row of a decoded head: the most candidates of
    one (image, class) whose score is > THRESHOLD, which the greedy loop of
    both NMS kernels walks."""
    return int((det.conf > THRESHOLD).sum(1).max().item())


def fused_vs_plain() -> float:
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.postprocess import postprocess

    rng = np.random.default_rng(0)
    worst, cases = 0.0, 0
    for b, h, w, a, c in GEOMETRIES:
        anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
        for density in ("bench", "saturated"):
            raw = seeded_raw(rng, b, h, w, a, c, density)
            for dtype in (torch.float32, torch.bfloat16):
                head = torch.from_numpy(raw).to("cuda", dtype)
                got = postprocess_fused(head, anchors, THRESHOLD, OVERLAP, TOPK)
                det = decode(head, anchors)
                want = postprocess(det, THRESHOLD, OVERLAP, TOPK)
                torch.cuda.synchronize()
                what = f"({b},{h},{w},{a * (5 + c)}) {density} {str(dtype)[6:]}"
                err = compare(got, want, c, what, det)
                worst, cases = max(worst, err), cases + 1
                log(f"[kernel] fused {what}: match, {int(want.keep.sum())} picks, longest "
                    f"compacted row {compacted(det)} of {h * w * a}, max abs err {err:.3g}")
    log(f"[kernel] fused: {cases} cases match the plain version; max abs err {worst:.3g}")
    return worst


def fused_one_launch() -> None:
    """One postprocess_fused call issues exactly one device kernel (no
    upcast, no keep, no memset or copy): torch.profiler over one call on a
    bf16 Darknet-416 head at batch 8, anchors already on the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from yolojax_torch.kernels.postprocess_fused import postprocess_fused

    rng = np.random.default_rng(12)
    anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (5, 2)).astype(np.float32)).cuda()
    raw = torch.from_numpy(seeded_raw(rng, 8, 13, 13, 5, 20, "bench")).to("cuda", torch.bfloat16)
    postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if len(device) != 1 or "postprocess_fused" not in device[0]:
        raise AssertionError(f"postprocess_fused: one call ran {len(device)} device "
                             f"activities {device}; expected the fused kernel alone")
    log(f"[kernel] fused: one call issues one device kernel ({device[0][:60]})")


def dw_inputs(rng, b, h, c, cout, dtype):
    """Seeded (x, taps, bd, wp, bp) on the card; He-scaled weights."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    x = f(rng.standard_normal((b, h, h, c))).to(dtype)
    wd = f(rng.standard_normal((3, 3, c)) * np.sqrt(2 / 9)).to(dtype)
    wp = f(rng.standard_normal((c, cout)) * np.sqrt(2 / c)).to(dtype)
    return x, wd, f(rng.normal(0, 0.1, c)), wp, f(rng.normal(0, 0.1, cout))


def dw_vs_plain() -> dict:
    """dwconv3x3 and dwsep against their plain versions; worst abs err each.
    dwconv3x3 must also be bit-identical to its tap-order reference, computed
    on the card with separate torch ops."""
    from yolojax_torch.kernels.dwconv import dwconv3x3, dwconv3x3_plain, dwconv3x3_taps
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
            taps = ""
            if name == "dwconv3x3":
                check_bits(got, dwconv3x3_taps(x, wd, bd, stride), f"{what} vs the tap order")
                taps = "; bit-identical to the tap-order reference"
            log(f"[kernel] {what}: match, max abs err {err:.3g}, "
                f"{100 * differ:.4f} % of elements not bit-identical to the plain version{taps}")
    log(f"[kernel] depthwise: {2 * len(cases)} cases match the plain versions; "
        f"max abs err {worst}")
    return worst


def decoded(rng, b, h, w, a, c, density: str):
    """A seeded raw head decoded on the card: (Detections, anchors)."""
    from yolojax_torch.ops.decode import decode

    anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)).cuda()
    raw = torch.from_numpy(seeded_raw(rng, b, h, w, a, c, density)).cuda()
    return decode(raw, anchors)


def nms_vs_plain() -> float:
    """nms_select against its plain version: idx, conf and valid identical,
    boxes broadcast over the classes and not; postprocess_nms as postprocess."""
    from yolojax_torch.kernels.nms import nms_select, postprocess_nms
    from yolojax_torch.ops.nms import nms_select as nms_plain
    from yolojax_torch.ops.postprocess import postprocess

    rng = np.random.default_rng(8)
    worst, cases = 0.0, 0
    for b, h, w, a, c in GEOMETRIES:
        for density in ("bench", "saturated"):
            det = decoded(rng, b, h, w, a, c, density)
            n = det.conf.shape[1]
            scores = det.conf.transpose(1, 2)
            boxes = {"broadcast": (det.yx_min[:, None], det.yx_max[:, None]),
                     "per class": (det.yx_min[:, None].expand(b, c, n, 2).contiguous(),
                                   det.yx_max[:, None].expand(b, c, n, 2).contiguous())}
            max_outs = (TOPK, 300) if (h, density) == (19, "saturated") else (TOPK,)
            for (layout, (yx_min, yx_max)) in boxes.items():
                for max_out in max_outs:
                    got = nms_select(yx_min, yx_max, scores, THRESHOLD, OVERLAP, max_out)
                    want = nms_plain(yx_min, yx_max, scores, THRESHOLD, OVERLAP, max_out)
                    torch.cuda.synchronize()
                    what = f"nms_select ({b},{c},{n}) {density} boxes {layout} max_out {max_out}"
                    for g, v, part in zip(got, want, ("idx", "conf", "valid")):
                        if g.shape != v.shape or g.dtype != v.dtype or not torch.equal(g, v):
                            raise AssertionError(f"{what}: {part} differs")
                    err = (got[1] - want[1]).abs().max().item()
                    worst, cases = max(worst, err), cases + 1
                    log(f"[kernel] {what}: identical, {int(want[2].sum())} picks, longest "
                        f"compacted row {compacted(det)}")
            got = postprocess_nms(det, THRESHOLD, OVERLAP, TOPK)
            want = postprocess(det, THRESHOLD, OVERLAP, TOPK)
            err = compare(got, want, c, f"postprocess_nms ({b},{c},{n}) {density}")
            worst, cases = max(worst, err), cases + 1
    log(f"[kernel] nms_select: {cases} cases match the plain version; max abs err {worst:.3g}")
    return worst


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def check_bits(got, want, what: str) -> float:
    """Same shape, dtype and bits; returns the largest abs difference (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"{what}: not bit-identical "
                             f"({(got != want).float().mean().item() * 100:.4f} % differ)")
    return (got.float() - want.float()).abs().max().item()


def layout_vs_plain() -> dict:
    """maxpool2x2 and reorg_s2d against their plain versions: bit-identical."""
    from yolojax_torch.kernels.pool import maxpool2x2, maxpool2x2_plain
    from yolojax_torch.kernels.reorg import reorg_s2d
    from yolojax_torch.ops.reorg import reorg_s2d as reorg_plain

    rng = np.random.default_rng(9)
    worst = {"maxpool2x2": 0.0, "reorg_s2d": 0.0}
    cases = [("maxpool2x2", (8, h, h, c)) for h, c in DARKNET_POOLS + TINY_POOLS]
    cases += [("maxpool2x2", shape) for shape in POOL_EXTRA]
    cases += [("reorg_s2d", (8, REORG_SHAPE[0], REORG_SHAPE[0], REORG_SHAPE[1]))]
    cases += [("reorg_s2d", shape) for shape in REORG_EXTRA]
    for name, shape in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)
            if name == "maxpool2x2":
                got, want = maxpool2x2(x), maxpool2x2_plain(x)
            else:
                got, want = reorg_s2d(x, 2), reorg_plain(x, 2)
            torch.cuda.synchronize()
            what = f"{name} {shape}->{tuple(want.shape)} {str(dtype)[6:]}"
            worst[name] = max(worst[name], check_bits(got, want, what))
            log(f"[kernel] {what}: bit-identical")
    log(f"[kernel] pool and reorg: {2 * len(cases)} cases bit-identical to the plain versions")
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


def in_turns(*fns) -> tuple[float, ...]:
    """Medians of ``fns`` timed in turns on one card, forth and back: for
    (plain, kernel) plain, kernel, kernel, plain; 8 runs each."""
    half = REPS // 2 + 1
    times = [cuda_ms(fn, half) for fn in fns]
    for i in reversed(range(len(fns))):
        times[i] += cuda_ms(fns[i], half)
    return tuple(float(np.median(t)) for t in times)


def launch_counters():
    from yolojax_torch.kernels.dwconv import dwconv3x3
    from yolojax_torch.kernels.dwsep import dwsep
    from yolojax_torch.kernels.nms import nms_select
    from yolojax_torch.kernels.pool import maxpool2x2
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.kernels.reorg import reorg_s2d

    return {"postprocess_fused": postprocess_fused, "dwconv3x3": dwconv3x3, "dwsep": dwsep,
            "nms_select": nms_select, "maxpool2x2": maxpool2x2, "reorg_s2d": reorg_s2d}


def seeded_images(seed: int, b: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (b, SIZE, SIZE, 3))
                            .astype(np.float32)).cuda()


def drive(config, what: str, expect: dict):
    """Drive ``detect_fn`` on seeded batches of 8 at the configured size, with
    every launch counter set to 0 just before and read just after; check the
    counts, the outputs and the plain postprocess of the same raw heads, then
    ``detect_image``.  Returns (model, params, state, folded, run, launches)."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.detect import detect_image
    from yolojax_torch.models.inference import Inference
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.postprocess import postprocess

    category, anchors, model = build(config)
    size = int(config.get("data", "sizes").split(",")[0])
    params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
    params["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = BENCH_OBJECTNESS
    inference = Inference(model)
    folded = inference.fold(params, state)
    run = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
    n_params = sum(lp["w"].numel() + lp["b"].numel() for lp in folded.values())
    log(f"[{what}] {type(model).__name__} {size}x{size}, {len(category)} classes, "
        f"{len(anchors)} anchors, {model.dtype}, reorg {model.reorg_order}, kernels "
        f"{sorted(model.pallas)}, {n_params} folded params")

    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.uniform(0, 1, (8, size, size, 3)).astype(np.float32))
               .to("cuda") for _ in range(3)]
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = [run(folded, x) for x in batches]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: n * len(batches) for name, n in expect.items()}
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
            if raw.shape != (8, size // 32, size // 32, model.out_channels):
                raise AssertionError(f"{what} batch {i}: raw head {tuple(raw.shape)}")
            det = decode(raw, anchors_t)
            plain = postprocess(det, THRESHOLD, OVERLAP, TOPK)
            compare(out, plain, model.num_classes, f"{what} batch {i}", det)
            picks = out.keep.sum(-1).float()
            log(f"[{what}] batch {i}: raw {tuple(raw.shape)} {raw.dtype}, keep matches the "
                f"plain postprocess; picks per (image, class) mean {picks.mean().item():.2f} "
                f"max {int(picks.max().item())}; longest compacted row {compacted(det)}")
    log(f"[{what}] detect_fn ran {len(batches)} batches; launches {launches}")

    image = np.random.default_rng(2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    ymin, ymax, cls, conf = detect_image(config, model, params, state, image, size)
    if not (ymin.shape == ymax.shape == (len(cls), 2) and len(conf) == len(cls)
            and np.isfinite(conf).all()):
        raise AssertionError(f"{what}: detect_image returned malformed detections")
    log(f"[{what}] detect_image on a 480x640 image returned {len(cls)} detections "
        f"(threshold {config.getfloat('detect', 'threshold')})")
    return model, params, state, folded, run, launches


def dense_batch(model, folded, run, what: str) -> None:
    """At the bench density a random head leaves every score under the
    threshold; hold the path's detections to the plain postprocess where there
    are picks too: objectness bias 0 on one more batch."""
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.postprocess import postprocess

    dense = dict(folded, out=dict(folded["out"], b=folded["out"]["b"].clone()))
    dense["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = 0.0
    x = seeded_images(7, 8)
    with torch.inference_mode():
        out = run(dense, x)
        det = decode(model.apply_folded(dense, x), torch.as_tensor(model.anchors, device="cuda"))
        plain = postprocess(det, THRESHOLD, OVERLAP, TOPK)
        compare(out, plain, model.num_classes, f"{what} dense batch", det)
    picks = out.keep.sum(-1).float()
    if not picks.max() > 0:
        raise AssertionError(f"{what} dense batch: no picks to compare")
    log(f"[{what}] dense batch (objectness bias 0): keep matches the plain postprocess; "
        f"picks per (image, class) mean {picks.mean().item():.2f} max {int(picks.max().item())}; "
        f"longest compacted row {compacted(det)} of {det.conf.shape[1]}")


def without(model, tokens: set):
    """The same model with the kernel ``tokens`` removed: it runs on the same
    folded weights (the plain path reads only their ``w`` and ``b``)."""
    return dataclasses.replace(model, pallas=model.pallas - set(tokens))


def raw_vs_without(model, folded, config_fn, drop: set, what: str, exact: bool) -> None:
    """The raw head against the same forward without the kernels ``drop``, on
    the same weights and images, in bf16 and (rebuilt from the same seed) in
    f32 with TF32 off.  ``exact``: kernels that change no value (pool,
    reorg), so the convs see the same inputs and the heads should be
    bit-identical; f32 must be, bf16 falls back to the 1 % bound if cuDNN's
    algorithm choice differs.  Otherwise: bf16 mean abs diff ≤ 1 % of mean
    |raw|, f32 rtol/atol 1e-3."""
    from yolojax_torch.cli.common import build, load_weights_auto

    label = " ".join(sorted(drop))
    x = seeded_images(5, 8)
    with torch.inference_mode():
        got = model.apply_folded(folded, x)
        want = without(model, drop).apply_folded(folded, x)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what} bf16: non-finite raw head")
        diff = (got.float() - want.float()).abs()
        ratio = diff.mean().item() / want.float().abs().mean().item()
        same = torch.equal(bits(got), bits(want))
        log(f"[{what}] bf16 raw head vs the forward without {label}: "
            f"{'bit-identical' if same else 'not bit-identical'}, max abs diff "
            f"{diff.max().item():.4g}, mean abs diff {diff.mean().item():.4g} = "
            f"{100 * ratio:.3f} % of mean |raw| {want.float().abs().mean().item():.4g}")
        if exact and not same:
            log(f"[{what}] bf16 raw head differs although {label} change no value: cuDNN "
                "chose other algorithms for the two forwards; held to the 1 % bound instead")
        if not (same or ratio <= 0.01):
            raise AssertionError(f"{what} bf16: mean abs diff {100 * ratio:.3f} % > 1 %")

        config32 = config_fn(dtype="float32")
        _, _, model32 = build(config32)
        params32, state32, _ = load_weights_auto(config32, model32, rng_seed=0, device="cuda")
        folded32 = model32.fold(params32, state32)
        got = model32.apply_folded(folded32, x)
        want = without(model32, drop).apply_folded(folded32, x)
        if exact:
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{what} f32 raw head: not bit-identical without {label} "
                                     f"(max abs diff {(got - want).abs().max().item():.4g})")
            log(f"[{what}] f32 raw head vs the forward without {label} (TF32 off): "
                "bit-identical")
        else:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3,
                                       msg=lambda m: f"{what} f32 raw head without {label}: {m}")
            log(f"[{what}] f32 raw head vs the forward without {label} (TF32 off): max abs "
                f"diff {(got - want).abs().max().item():.4g} within rtol/atol 1e-3")


def darknet_path():
    from yolojax_torch.config import load_config

    config = load_config(None)      # the repo's config.ini: Darknet-19, VOC, bf16, fusedpost
    return drive(config, "darknet", DARKNET_LAUNCHES)


def mobilenet_config(tokens: str = MOBILENET_TOKENS, dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    return load_config([str(ROOT / "config.ini"), str(ROOT / "config" / "mobilenet.ini")],
                       [f"model/pallas={tokens}", f"model/dtype={dtype}"])


def s2d_config(tokens: str = S2D_TOKENS, dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    return load_config([str(ROOT / "config.ini")],
                       ["model/reorg=s2d", f"model/pallas={tokens}", f"model/dtype={dtype}"])


def tiny_config(tokens: str = TINY_TOKENS, dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    return load_config([str(ROOT / "config.ini"), str(ROOT / "config" / "tiny.ini")],
                       [f"model/pallas={tokens}", f"model/dtype={dtype}"])


DW_TOKENS = {"dwsep", "dwconv"}


def kernel_path(what: str, config_fn, expect: dict, drop: set, exact: bool):
    """A main path through kernels of the forward: drive it, check a dense
    batch, and hold its raw head to the forward without those kernels."""
    model, _, _, folded, run, launches = drive(config_fn(), what, expect)
    dense_batch(model, folded, run, what)
    raw_vs_without(model, folded, config_fn, drop, what, exact)
    return model, folded, run, launches


def darknet_times(model, folded, run, card: str) -> dict:
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.postprocess import postprocess_raw

    anchors = torch.as_tensor(model.anchors, device="cuda")
    rng = np.random.default_rng(3)
    result = {}
    with torch.inference_mode():
        for b in TIME_BATCHES:
            x = torch.from_numpy(rng.uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)).cuda()
            raw = model.apply_folded(folded, x)
            t_plain, t_kernel = in_turns(
                lambda: postprocess_raw(raw, anchors, THRESHOLD, OVERLAP, TOPK),
                lambda: postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK))
            out = postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
            # bytes: the head and anchors in, the PostProcessed out; operations:
            # the decode (~3 per class score and 20 per candidate) and, for
            # this head's picks, an argmax and an IoU (~16) per candidate
            n, c = raw.shape[1] * raw.shape[2] * len(model.anchors), model.num_classes
            ops = b * n * (3 * c + 20) + int(out.keep.sum()) * n * 16
            bound = Bound().add(nbytes(raw, anchors, *out), {"f32": ops})
            t_fwd = float(np.median(cuda_ms(lambda: model.apply_folded(folded, x))))
            t_detect = cuda_ms(lambda: run(folded, x))
            med = float(np.median(t_detect))
            result[b] = {"kernel_ms": t_kernel, "plain_ms": t_plain, "forward_ms": t_fwd,
                         "detect_ms": med, "img_per_s": b / (med / 1e3),
                         "bound_ms": bound.total, "bound_by": bound.by}
            log(f"[time] {card} | raw {tuple(raw.shape)} {raw.dtype}: fused kernel "
                f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms (median of 8 / 8); bound "
                f"{bound.total:.5f} ms by {bound.by}, {int(out.keep.sum())} picks; no "
                "PyTorch call computes it")
            log(f"[time] {card} | Darknet detect batch {b} at {SIZE}: {med:.3f} ms = "
                f"{result[b]['img_per_s']:.1f} img/s (forward alone {t_fwd:.3f} ms; "
                f"median of {REPS}); all runs {[round(t, 3) for t in t_detect]}")
    return result


def dw_times(card: str) -> dict:
    """Each routed layer shape, kernel against plain version and (dwconv3x3)
    the library's grouped conv, bf16, in turns; returns per (name, batch)
    the sums over one forward's routed layers, with their bound."""
    import torch.nn.functional as F

    from yolojax_torch.kernels.dwconv import dwconv3x3, dwconv3x3_plain
    from yolojax_torch.kernels.dwsep import dwsep, dwsep_plain

    rng = np.random.default_rng(6)
    sums = {}
    for b in TIME_BATCHES:
        for name, layers in (("dwconv3x3", DWCONV_LAYERS), ("dwsep", DWSEP_LAYERS)):
            total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
            bound = Bound()
            for count, h, c, cout, stride in layers:
                x, wd, bd, wp, bp = dw_inputs(rng, b, h, c, cout, torch.bfloat16)
                ho = (h - 1) // stride + 1
                pixels = b * ho * ho
                dw_flops = 2 * 9 * pixels * c
                if name == "dwconv3x3":
                    # the TPU kernel's function: the grouped conv, no epilogue
                    xc, weight = x.permute(0, 3, 1, 2), wd.permute(2, 0, 1).unsqueeze(1)
                    t_plain, t_kernel, t_lib = in_turns(
                        lambda: dwconv3x3_plain(x, wd, bd, stride),
                        lambda: dwconv3x3(x, wd, bd, stride),
                        lambda: F.conv2d(xc, weight, stride=stride, padding=1, groups=c))
                    work = (nbytes(x, wd, bd) + pixels * c * 2, {"f32": dw_flops})
                    flops = dw_flops
                else:
                    wp_t = wp.t().contiguous()
                    t_plain, t_kernel = in_turns(
                        lambda: dwsep_plain(x, wd, bd, wp, bp, stride),
                        lambda: dwsep(x, wd, bd, wp, bp, stride, wp_t))
                    t_lib = None
                    flops = 2 * pixels * c * cout
                    work = (nbytes(x, wd, bd, wp, bp) + pixels * cout * 2,
                            {"bf16 tensor": flops, "f32": dw_flops})
                layer = Bound().add(*work)
                bound.add(*work, count=count)
                total["ms"] += count * t_kernel
                total["plain_ms"] += count * t_plain
                total["library_ms"] = None if t_lib is None else total["library_ms"] + count * t_lib
                lib = "" if t_lib is None else f", library {t_lib:.4f} ms"
                log(f"[time] {card} | {name} ({b},{h},{h},{c})->{cout} s{stride} bf16: kernel "
                    f"{t_kernel:.4f} ms = {flops / t_kernel / 1e9:.1f} TFLOP/s, "
                    f"{100 * layer.total / t_kernel:.1f} % of its bound {layer.total:.4f} ms "
                    f"({layer.by}); plain {t_plain:.4f} ms{lib} (median of 8 / 8; "
                    f"{count}x per forward)")
            sums[(name, b)] = dict(total, bound_ms=bound.total, bound_by=bound.by)
            lib = ("" if total["library_ms"] is None
                   else f", library {total['library_ms']:.4f} ms")
            log(f"[time] {card} | {name} per MobileNet-416 forward at batch {b}: kernel "
                f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms{lib}, bound "
                f"{bound.total:.4f} ms ({bound.by}) = {100 * bound.total / total['ms']:.1f} % "
                "of the kernel's time")
    return sums


def detect_times(model, folded, run, drop: set, name: str, card: str) -> dict:
    """detect images/s with the path's kernels and without the forward
    kernels ``drop``, in turns, at each timed batch."""
    from yolojax_torch.models.inference import Inference

    plain_run = Inference(without(model, drop)).detect_fn(THRESHOLD, OVERLAP, TOPK)
    result = {}
    for b in TIME_BATCHES:
        x = seeded_images(3, b)
        t_plain, t_kernel = in_turns(lambda: plain_run(folded, x), lambda: run(folded, x))
        result[b] = {"detect_ms": t_kernel, "img_per_s": b / (t_kernel / 1e3),
                     "plain_detect_ms": t_plain, "plain_img_per_s": b / (t_plain / 1e3)}
        log(f"[time] {card} | {name} detect batch {b} at {SIZE}: with {sorted(model.pallas)} "
            f"{t_kernel:.3f} ms = {result[b]['img_per_s']:.1f} img/s; without "
            f"{' '.join(sorted(drop))} {t_plain:.3f} ms = {result[b]['plain_img_per_s']:.1f} "
            "img/s (median of 8 / 8)")
    return result


def nms_times(model, folded, card: str) -> dict:
    """nms_select against its plain version on Darknet-s2d's decoded heads."""
    from yolojax_torch.kernels.nms import nms_select
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.nms import nms_select as nms_plain

    anchors = torch.as_tensor(model.anchors, device="cuda")
    result = {}
    with torch.inference_mode():
        for b in TIME_BATCHES:
            det = decode(model.apply_folded(folded, seeded_images(3, b)), anchors)
            args = (det.yx_min[:, None], det.yx_max[:, None], det.conf.transpose(1, 2),
                    THRESHOLD, OVERLAP, TOPK)
            t_plain, t_kernel = in_turns(lambda: nms_plain(*args), lambda: nms_select(*args))
            # bytes: boxes and scores in, idx, conf and valid out; operations:
            # an argmax and an IoU (~16) per candidate for each of this
            # head's picks
            picks = nms_select(*args)
            n = args[2].shape[-1]
            bound = Bound().add(nbytes(*args[:3], *picks), {"f32": int(picks[2].sum()) * n * 16})
            result[b] = {"ms": t_kernel, "plain_ms": t_plain, "library_ms": None,
                         "bound_ms": bound.total, "bound_by": bound.by}
            log(f"[time] {card} | nms_select scores {tuple(args[2].shape)}, boxes "
                f"{tuple(args[0].shape)}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms "
                f"(median of 8 / 8); bound {bound.total:.5f} ms by {bound.by}, "
                f"{int(picks[2].sum())} picks; no PyTorch call computes it")
    return result


def layout_times(card: str) -> dict:
    """maxpool2x2 per routed shape (summed per Darknet and per Tiny forward)
    against its plain version and ``F.max_pool2d``, and reorg_s2d at c21's
    shape against its plain version, bf16, in turns."""
    import torch.nn.functional as F

    from yolojax_torch.kernels.pool import maxpool2x2, maxpool2x2_plain
    from yolojax_torch.kernels.reorg import reorg_s2d
    from yolojax_torch.ops.reorg import reorg_s2d as reorg_plain

    rng = np.random.default_rng(10)
    x_of = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    result = {}
    for b in TIME_BATCHES:
        for model_name, pools in (("Darknet", DARKNET_POOLS), ("Tiny", TINY_POOLS)):
            total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
            bound = Bound()
            for h, c in pools:
                x = x_of((b, h, h, c))
                xc = x.permute(0, 3, 1, 2)
                t_plain, t_kernel, t_lib = in_turns(lambda: maxpool2x2_plain(x),
                                                    lambda: maxpool2x2(x),
                                                    lambda: F.max_pool2d(xc, 2, 2))
                for key, t in zip(total, (t_kernel, t_plain, t_lib)):
                    total[key] += t
                # three compares per output element
                work = (nbytes(x) * 5 // 4, {"f32": 3 * x.numel() // 4})
                layer = Bound().add(*work)
                bound.add(*work)
                log(f"[time] {card} | maxpool2x2 ({b},{h},{h},{c}) bf16: kernel {t_kernel:.4f} "
                    f"ms = {nbytes(x) * 1.25 / 1e9 / (t_kernel / 1e3):.0f} GB/s, "
                    f"{100 * layer.total / t_kernel:.1f} % of its bound {layer.total:.4f} ms; "
                    f"plain {t_plain:.4f} ms, F.max_pool2d {t_lib:.4f} ms (median of 8 / 8)")
            result[("maxpool2x2", model_name, b)] = dict(total, bound_ms=bound.total,
                                                         bound_by=bound.by)
            log(f"[time] {card} | maxpool2x2 per {model_name}-416 forward at batch {b}: kernel "
                f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, F.max_pool2d "
                f"{total['library_ms']:.4f} ms, bound {bound.total:.4f} ms ({bound.by})")
        x = x_of((b, REORG_SHAPE[0], REORG_SHAPE[0], REORG_SHAPE[1]))
        t_plain, t_kernel = in_turns(lambda: reorg_plain(x, 2), lambda: reorg_s2d(x, 2))
        bound = Bound().add(2 * nbytes(x))
        result[("reorg_s2d", b)] = {"ms": t_kernel, "plain_ms": t_plain, "library_ms": None,
                                    "bound_ms": bound.total, "bound_by": bound.by}
        log(f"[time] {card} | reorg_s2d {tuple(x.shape)} bf16: kernel {t_kernel:.4f} ms, plain "
            f"{t_plain:.4f} ms (median of 8 / 8); bound {bound.total:.5f} ms by bytes; no "
            "PyTorch call computes it (pixel_unshuffle orders channels c*4+p*2+q)")
    return result


def host_split(card: str) -> dict:
    """Where a kernel wrapper's host time goes: each part of a maxpool2x2
    call at Tiny's batch-8 pool4 shape, (8, 52, 52, 128) bf16, timed alone
    with ``time.perf_counter_ns``, the median of HOST_ROUNDS rounds of
    HOST_CALLS calls (a round's mean picks up the host's hiccups), beside
    the whole wrapper, the engine's call with its permutes and
    ``F.max_pool2d``; then the fused decode+NMS wrapper on a batch-8 bf16
    head and its ``Kernel`` call alone.  The device context and the
    ``torch.cuda.Stream`` lookup are the parts the first launch path paid on
    every call; the current device index, the raw stream handle and
    ``new_empty`` are what ``_build.Kernel`` and the wrappers use instead."""
    import ctypes

    import torch.nn.functional as F

    from yolojax_torch.kernels import _build, pool
    from yolojax_torch.kernels import postprocess_fused as pf
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((8, 52, 52, 128))
                         .astype(np.float32)).to("cuda", torch.bfloat16)
    raw = torch.from_numpy(seeded_raw(rng, 8, 13, 13, 5, 20, "bench")).to("cuda", torch.bfloat16)
    anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (5, 2)).astype(np.float32)).cuda()
    out = postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
    group, smem = pf.layout(845, 20, 8, torch.cuda.get_device_properties(0).multi_processor_count)
    fused_args = (raw.data_ptr(), anchors.data_ptr(), *(t.data_ptr() for t in out), 8, 13, 13, 5,
                  20, group, smem, THRESHOLD, OVERLAP, TOPK, 1)
    xc = x.permute(0, 3, 1, 2)
    y = pool.maxpool2x2(x)
    shape, dev = tuple(y.shape), x.device
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib = _build.load(pool.SOURCE, {"yolo_maxpool2x2": [ptr, ptr, i32, i32, i32, i32, i32, ptr]})
    stream = torch.cuda.current_stream(dev).cuda_stream
    xp, yp = x.data_ptr(), y.data_ptr()
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    get_device = getattr(torch._C, "_cuda_getDevice", None)

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "device context, enter and exit": context,
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev)
        .cuda_stream,
        "_build.load(source) lookup": lambda: _build.load(pool.SOURCE, {}),
        "current device index": get_device,
        "raw stream handle": (lambda: raw_stream(0)) if raw_stream else None,
        "_check(x)": lambda: pool._check(x),
        "torch.empty(out)": lambda: torch.empty(shape, dtype=x.dtype, device=dev),
        "x.new_empty(out)": lambda: x.new_empty(shape),
        "data_ptr() of x and out": lambda: (x.data_ptr(), y.data_ptr()),
        "ctypes call with its launch": lambda: lib.yolo_maxpool2x2(xp, yp, 8, 52, 52, 128, 1,
                                                                   stream),
        "Kernel call: lookups, ctypes call, launch, error check": lambda: pool._KERNEL(
            x, xp, yp, 8, 52, 52, 128, 1),
        "the engine's two permutes": lambda: xc.permute(0, 2, 3, 1).permute(0, 3, 1, 2),
        "maxpool2x2(x), the whole wrapper": lambda: pool.maxpool2x2(x),
        "the engine's call, permutes and wrapper": lambda: pool.maxpool2x2(
            xc.permute(0, 2, 3, 1)).permute(0, 3, 1, 2),
        "F.max_pool2d(x_nchw, 2, 2)": lambda: F.max_pool2d(xc, 2, 2),
        "postprocess_fused, the whole wrapper (B=8 bf16 head)": lambda: postprocess_fused(
            raw, anchors, THRESHOLD, OVERLAP, TOPK),
        "postprocess_fused's Kernel call alone": lambda: pf._KERNEL(raw, *fused_args),
    }
    result = {}
    for what, fn in parts.items():
        if fn is None:
            log(f"[host] {what}: not in this torch")
            continue
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(HOST_ROUNDS):
            t0 = time.perf_counter_ns()
            for _ in range(HOST_CALLS):
                fn()
            rounds.append((time.perf_counter_ns() - t0) / HOST_CALLS / 1e3)
            torch.cuda.synchronize()
        result[what] = float(np.median(rounds))
        log(f"[host] {card} | {what}: {result[what]:.2f} us per call (median of {HOST_ROUNDS} "
            f"rounds of {HOST_CALLS}; rounds {min(rounds):.2f}-{max(rounds):.2f})")
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
    for what, m in (("dwsep+dwconv", model), ("cuDNN path", without(model, DW_TOKENS))):
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
    t0 = time.perf_counter()
    host_split(card)
    err = {"postprocess_fused": fused_vs_plain(), **dw_vs_plain(), "nms_select": nms_vs_plain(),
           **layout_vs_plain()}
    fused_one_launch()
    # each model's times right after its path, so Darknet's stay comparable
    # with runs that drive Darknet alone
    dark_model, _, _, dark_folded, dark_run, dark_launches = darknet_path()
    dark_t = darknet_times(dark_model, dark_folded, dark_run, card)
    del dark_model, dark_folded, dark_run
    mob_model, mob_folded, mob_run, mob_launches = kernel_path(
        "mobilenet", mobilenet_config, MOBILENET_LAUNCHES, DW_TOKENS, exact=False)
    dw_t = dw_times(card)
    detect_times(mob_model, mob_folded, mob_run, DW_TOKENS, "MobileNet", card)
    del mob_model, mob_folded, mob_run
    s2d_model, s2d_folded, s2d_run, s2d_launches = kernel_path(
        "darknet-s2d", s2d_config, S2D_LAUNCHES, {"pool", "reorg"}, exact=True)
    nms_t = nms_times(s2d_model, s2d_folded, card)
    detect_times(s2d_model, s2d_folded, s2d_run, {"pool", "reorg"}, "Darknet-s2d", card)
    del s2d_model, s2d_folded, s2d_run
    tiny_model, tiny_folded, tiny_run, tiny_launches = kernel_path(
        "tiny", tiny_config, TINY_LAUNCHES, {"pool"}, exact=True)
    detect_times(tiny_model, tiny_folded, tiny_run, {"pool"}, "Tiny", card)
    del tiny_model, tiny_folded, tiny_run
    layout_t = layout_times(card)
    log(f"[done] checks and times took {time.perf_counter() - t0:.1f} s after the build")

    # launches: summed over the four main paths' runs (3 batches each); ms,
    # plain_ms, library_ms and bound_ms at batch 8: fused on Darknet's raw
    # head, nms_select on Darknet-s2d's decoded head, dwconv3x3 and dwsep
    # summed over one MobileNet-416 forward's routed layers, maxpool2x2 over
    # one Darknet-416 forward's routed pools, reorg_s2d at c21's shape
    paths = (dark_launches, mob_launches, s2d_launches, tiny_launches)
    b = TIME_BATCHES[0]
    fused = dark_t[b]
    times = {"postprocess_fused": {"ms": fused["kernel_ms"], "plain_ms": fused["plain_ms"],
                                   "library_ms": None, "bound_ms": fused["bound_ms"],
                                   "bound_by": fused["bound_by"]},
             "dwconv3x3": dw_t[("dwconv3x3", b)], "dwsep": dw_t[("dwsep", b)],
             "nms_select": nms_t[b], "maxpool2x2": layout_t[("maxpool2x2", "Darknet", b)],
             "reorg_s2d": layout_t[("reorg_s2d", b)]}
    sources = {"postprocess_fused": ("postprocess_fused.cu", "yolojax/kernels/nms.py:247"),
               "dwconv3x3": ("dwconv3x3.cu", "yolojax/kernels/dwconv.py:65"),
               "dwsep": ("dwsep.cu", "yolojax/kernels/dwsep.py:104"),
               "nms_select": ("nms_select.cu", "yolojax/kernels/nms.py:118"),
               "maxpool2x2": ("maxpool2x2.cu", "yolojax/kernels/pool.py:40"),
               "reorg_s2d": ("reorg_s2d.cu", "yolojax/kernels/reorg.py:38")}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": f"yolojax_torch/csrc/{sources[k][0]}",
         "replaces": sources[k][1], "launches": sum(p[k] for p in paths),
         "max_abs_err": err[k], "ms": times[k]["ms"], "plain_ms": times[k]["plain_ms"],
         "bound_ms": times[k]["bound_ms"], "bound_by": times[k]["bound_by"],
         "library_ms": times[k]["library_ms"]}
        for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
