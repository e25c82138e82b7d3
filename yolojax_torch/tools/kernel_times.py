"""Time kernels of two checkouts of the port in turns, on one card.

    python yolojax_torch/tools/kernel_times.py --root DIR          # DIR's kernels: one JSON line
    python yolojax_torch/tools/kernel_times.py --turns OTHER_DIR   # OTHER, this, this, OTHER

Each ``--root`` run imports ``yolojax_torch`` from DIR, builds its kernels
there and times them on the same seeded inputs, at batch 8 and 128, bf16:
the fused decode+NMS kernel and nms_select on VOC-416 heads (B, 13, 13, 125)
at the bench density (objectness near −6) and saturated (objectness logits
N(0, 4)) (nms_select on the f32 decode); dwconv3x3 summed over
MobileNet-416's four routed layers; the routed pools' work summed over
Darknet's three (c5, c8, c13 before pool3-pool5) and Tiny's two (c4, c5
before pool4-pool5) and the passthrough's reorg at c21, each as the
checkout's engine runs it on the conv's raw output (a checkout whose
kernels take no bias: ``bias_leaky``, then the kernel, then ``torch.cat``
for the reorg); and Darknet-s2d and Tiny detect per call (full width, 416,
seeded random weights), with the device kernels of one forward.  Two
numbers per case: the time of one call between CUDA events (3 warm-up
calls, median of 7), which holds the wrapper's host time where the card
waits for it, and the device time of one call (``torch.profiler`` over 5
calls: every kernel, copy and fill the call issues).  ``--turns`` runs the
other checkout, this one twice, then the other again, each in its own
process, and prints every case with the checkouts' numbers side by side.
It needs a CUDA device, and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

THRESHOLD, OVERLAP, TOPK = 0.005, 0.45, 100
BATCHES = (8, 128)
# MobileNet-416's routed depthwise layers: (H, C, stride)
DWCONV_LAYERS = [(104, 128, 1), (104, 128, 2), (52, 256, 1), (52, 256, 2)]
# the routed pools' raw conv outputs (H, C) and whether the full output is kept
POOLS = {"Darknet": [(104, 128, False), (52, 256, False), (26, 512, True)],
         "Tiny": [(52, 128, False), (26, 256, False)]}
HERE = Path(__file__).resolve()


def seeded_raw(rng, b, h, w, a, c, density: str) -> np.ndarray:
    raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 2).astype(np.float32)
    if density == "bench":
        obj = raw.reshape(b, h, w, a, 5 + c)[..., 4]
        obj[...] = -6.0 + 0.5 * obj
    return raw


def measure(root: str) -> dict:
    sys.path.insert(0, root)
    import torch

    from yolojax_torch.kernels.dwconv import dwconv3x3
    from yolojax_torch.kernels.nms import nms_select
    from yolojax_torch.kernels.pool import maxpool2x2
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.kernels.reorg import reorg_s2d
    from yolojax_torch.models.blocks import bias_leaky
    from yolojax_torch.ops.decode import decode

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")

    def median_ms(fn, reps: int = 7) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def device_us(fn, calls: int = 5) -> float:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / calls

    def time_case(name, fn):
        times[name] = median_ms(fn)
        device[name] = device_us(fn)

    # the routed pool and reorg steps on a conv's raw output, as this
    # checkout's engine runs them
    nhwc = lambda t: t.permute(0, 2, 3, 1)
    if "bias" in inspect.signature(maxpool2x2).parameters:
        pool_step = lambda x, bias, full: maxpool2x2(x, bias, True, full)
        reorg_step = lambda x, tail, bias: reorg_s2d(x, 2, tail, bias)
    else:
        def pool_step(x, bias, full):
            y = nhwc(bias_leaky(x.permute(0, 3, 1, 2), bias))
            return maxpool2x2(y), y

        def reorg_step(x, tail, bias):
            y = reorg_s2d(nhwc(bias_leaky(x.permute(0, 3, 1, 2), bias)), 2)
            return torch.cat([y.permute(0, 3, 1, 2), tail.permute(0, 3, 1, 2)], 1)

    rng = np.random.default_rng(0)
    anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (5, 2)).astype(np.float32)).cuda()
    times, device = {}, {}
    bf16 = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    f32 = lambda shape: torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32)).cuda()
    with torch.inference_mode():
        for b in BATCHES:
            for density in ("bench", "saturated"):
                raw32 = torch.from_numpy(seeded_raw(rng, b, 13, 13, 5, 20, density)).cuda()
                raw = raw32.to(torch.bfloat16)
                time_case(f"fused {density} B={b}",
                          lambda: postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK))
                det = decode(raw32, anchors)
                args = (det.yx_min[:, None], det.yx_max[:, None], det.conf.transpose(1, 2),
                        THRESHOLD, OVERLAP, TOPK)
                time_case(f"nms_select {density} B={b}", lambda: nms_select(*args))
            total = dev_total = 0.0
            for h, c, stride in DWCONV_LAYERS:
                x = bf16((b, h, h, c))
                w = bf16((3, 3, c)) * 0.47
                bias = f32(c)
                total += median_ms(lambda: dwconv3x3(x, w, bias, stride))
                dev_total += device_us(lambda: dwconv3x3(x, w, bias, stride))
            times[f"dwconv3x3 4 layers B={b}"] = total
            device[f"dwconv3x3 4 layers B={b}"] = dev_total
            for model, pools in POOLS.items():
                total = dev_total = 0.0
                for h, c, full in pools:
                    x, bias = bf16((b, h, h, c)), f32(c)
                    total += median_ms(lambda: pool_step(x, bias, full))
                    dev_total += device_us(lambda: pool_step(x, bias, full))
                times[f"maxpool2x2 {model}'s {len(pools)} B={b}"] = total
                device[f"maxpool2x2 {model}'s {len(pools)} B={b}"] = dev_total
            x, tail, bias = bf16((b, 26, 26, 64)), bf16((b, 13, 13, 1024)), f32(64)
            time_case(f"reorg_s2d c21 + concat B={b}", lambda: reorg_step(x, tail, bias))
    forwards = forward_times(root)
    return {"root": root, "device": torch.cuda.get_device_name(0), "times": {**times, **{
        k: v["ms"] for k, v in forwards.items()}}, "device_us": {**device, **{
            k: v["device_us"] for k, v in forwards.items()}},
        "kernels_per_forward": {k: v["kernels"] for k, v in forwards.items()}}


def forward_times(root: str) -> dict:
    """Darknet-s2d and Tiny detect per call at 416, batch 8 and 128: one
    call's time (median of 7) and device time, and the device kernels of one
    forward (``torch.profiler``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.config import load_config
    from yolojax_torch.models.inference import Inference

    paths = {"Darknet-s2d": (["config.ini"], ["model/reorg=s2d", "model/pallas=nms pool reorg"]),
             "Tiny": (["config.ini", "config/tiny.ini"], ["model/pallas=nms fusedpost pool"])}
    result = {}
    for name, (files, overrides) in paths.items():
        config = load_config([str(Path(root) / f) for f in files], overrides)
        _, _, model = build(config)
        params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
        params["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = -6.0
        inference = Inference(model)
        folded = inference.fold(params, state)
        run = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
        for b in BATCHES:
            x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (b, 416, 416, 3))
                                 .astype(np.float32)).cuda()
            with torch.inference_mode():
                for _ in range(3):
                    run(folded, x)
                torch.cuda.synchronize()
                times = []
                for _ in range(7):
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                    run(folded, x)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                detect = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                with detect:
                    run(folded, x)
                    torch.cuda.synchronize()
                forward = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                with forward:
                    model.apply_folded(folded, x)
                    torch.cuda.synchronize()
            on_device = lambda prof: [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            result[f"{name} detect B={b}"] = {
                "ms": float(np.median(times)), "kernels": len(on_device(forward)),
                "device_us": sum(e.self_device_time_total for e in on_device(detect))}
    return result


def turns(other: str) -> None:
    this = str(HERE.parents[2])
    runs = []
    for root in (other, this, this, other):
        proc = subprocess.run([sys.executable, str(HERE), "--root", root], capture_output=True,
                              text=True, timeout=1200, check=False)
        if proc.returncode != 0:
            raise SystemExit(f"kernel_times: the run of {root} failed:\n{proc.stderr[-3000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    print(f"[turns] {runs[0]['device']}; ms per call, median of 7, runs in the order "
          f"other, this, this, other (other = {other})", flush=True)
    for case in runs[0]["times"]:
        o, t = (runs[0], runs[3]), (runs[1], runs[2])
        print(f"[turns] {case}: one call, ms: other {o[0]['times'][case]:.4f} / "
              f"{o[1]['times'][case]:.4f}, this {t[0]['times'][case]:.4f} / "
              f"{t[1]['times'][case]:.4f}; device us: other {o[0]['device_us'][case]:.1f} / "
              f"{o[1]['device_us'][case]:.1f}, this {t[0]['device_us'][case]:.1f} / "
              f"{t[1]['device_us'][case]:.1f}", flush=True)
    for case in runs[0]["kernels_per_forward"]:
        print(f"[turns] {case}: device kernels per forward (torch.profiler): other "
              f"{runs[0]['kernels_per_forward'][case]} / {runs[3]['kernels_per_forward'][case]}, "
              f"this {runs[1]['kernels_per_forward'][case]} / "
              f"{runs[2]['kernels_per_forward'][case]}", flush=True)
    print(json.dumps({"turns": runs}), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--root", help="a checkout whose kernels to time")
    group.add_argument("--turns", metavar="OTHER", help="a second checkout to time in turns")
    args = parser.parse_args()
    if args.turns:
        turns(args.turns)
    else:
        print(json.dumps(measure(args.root)), flush=True)


if __name__ == "__main__":
    main()
