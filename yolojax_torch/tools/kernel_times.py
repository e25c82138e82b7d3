"""Time kernels of two checkouts of the port in turns, on one card.

    python yolojax_torch/tools/kernel_times.py --root DIR          # DIR's kernels: one JSON line
    python yolojax_torch/tools/kernel_times.py --turns OTHER_DIR   # OTHER, this, this, OTHER

Each ``--root`` run imports ``yolojax_torch`` from DIR, builds its kernels
there and times them on the same seeded inputs: the fused decode+NMS kernel
and nms_select on VOC-416 heads (B, 13, 13, 125) at the bench density
(objectness near −6) and saturated (objectness logits N(0, 4)), and
dwconv3x3 summed over MobileNet-416's four routed layers, at batch 8 and
128, bf16 (nms_select on the f32 decode).  Two numbers per case: the time
of one call between CUDA events (3 warm-up calls, median of 7), which
holds the wrapper's host time where the card waits for it, and the device
time of one call (``torch.profiler`` over 5 calls: every kernel, copy and
fill the call issues).  ``--turns`` runs the other checkout, this one
twice, then the other again, each in its own process, and prints every
case with the checkouts' numbers side by side.  It needs a CUDA device, and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

THRESHOLD, OVERLAP, TOPK = 0.005, 0.45, 100
BATCHES = (8, 128)
# MobileNet-416's routed depthwise layers: (H, C, stride)
DWCONV_LAYERS = [(104, 128, 1), (104, 128, 2), (52, 256, 1), (52, 256, 2)]
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
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
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

    rng = np.random.default_rng(0)
    anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (5, 2)).astype(np.float32)).cuda()
    times, device = {}, {}
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
                x = torch.from_numpy(rng.standard_normal((b, h, h, c)).astype(np.float32)).to(
                    "cuda", torch.bfloat16)
                w = torch.from_numpy((rng.standard_normal((3, 3, c)) * 0.47).astype(np.float32)
                                     ).to("cuda", torch.bfloat16)
                bias = torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)).cuda()
                total += median_ms(lambda: dwconv3x3(x, w, bias, stride))
                dev_total += device_us(lambda: dwconv3x3(x, w, bias, stride))
            times[f"dwconv3x3 4 layers B={b}"] = total
            device[f"dwconv3x3 4 layers B={b}"] = dev_total
    return {"root": root, "device": torch.cuda.get_device_name(0), "times": times,
            "device_us": device}


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
