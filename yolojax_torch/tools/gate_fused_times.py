"""The fused decode+NMS kernel at eval's point on a trained gate's heads.

    python -m yolojax_torch.tools.gate_fused_times [--root DIR] [--model darknet]
        [--format voc] [--classes 8] [--out PATH]

Run after ``python -m yolojax_torch.tools.synth_gate`` with the same flags:
it loads that workspace's latest checkpoint on the card, computes the raw
heads of the first eval batch (``[eval] batch_size``, 20 in the gate) at 416
and 608, stretch, in the config's dtype, and times the fused kernel
(``kernels/postprocess_fused.py``) at eval's threshold, overlap and topk
against its plain version (``ops/postprocess.py::postprocess_raw``), in
turns: the one-call time between CUDA events (3 warm-up calls, median of
8 + 8), the device time of one call (``torch.profiler``, the median of the
kernel's recorded events over 20 calls; CUDA events around one call
where it recorded none), the picks, the longest compacted row (the most
candidates of one image and class above the threshold, which the greedy
loop walks) and the bound: the larger of the bytes moved (the head and the
anchors read once, the outputs written once) over 3.35 TB/s and the float32
operations (the decode, ~3 per class score and 20 per candidate, and an
argmax and an IoU, ~16, per candidate per pick) over 67 TFLOP/s, an H100
SXM's HBM3 rate and float32 peak.  Prints one JSON line, also written to
``--out``.  It needs a CUDA device, and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .kernel_timing import bound, decode_nms_ops, device_us, event_ms, nbytes
from .synth_gate import REPO, gate_parser

SIZES = (416, 608)
REPS = 8


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], parents=[gate_parser()],
                                 add_help=False, conflict_handler="resolve")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("gate_fused_times times the card's kernel; torch sees no CUDA device")

    from ..cli import make_parser, setup
    from ..cli.common import build, load_weights_auto
    from ..config import get_canvas
    from ..data.cache import load_cache
    from ..data.dataset import Dataset, collate
    from ..data.transform import resize_from_config
    from ..kernels.postprocess_fused import postprocess_fused
    from ..models.inference import Inference
    from ..ops.decode import decode
    from ..ops.postprocess import postprocess_raw

    cfg = ["-c", os.path.join(REPO, "config.ini")]
    if args.model != "darknet":
        cfg.append(os.path.join(REPO, "config", f"{args.model}.ini"))
    cfg.append(os.path.join(args.root, "gate.ini"))
    config = setup(make_parser("gate fused times").parse_args(cfg))
    config.set("transform", "resize", "yolojax.data.transform.stretch")
    _, anchors, model = build(config)
    params, state, meta = load_weights_auto(config, model, None, resume=True, device="cuda")
    folded = Inference(model).fold(params, state)
    threshold = config.getfloat("eval", "threshold", fallback=0.005)
    overlap = config.getfloat("eval", "overlap", fallback=0.45)
    topk = config.getint("eval", "topk", fallback=300)
    batch = config.getint("eval", "batch_size")
    records = load_cache(config, "val" if args.format == "coco" else "test")[:batch]
    dataset = Dataset(records, canvas=get_canvas(config))
    host = collate([dataset.load(i) for i in range(len(dataset))])
    anchors = torch.as_tensor(np.asarray(model.anchors, np.float32), device="cuda")
    card = torch.cuda.get_device_name(0)
    out = {"card": card, "model": args.model, "format": args.format, "classes": args.classes,
           "step": int(meta.get("step", 0) or 0), "threshold": threshold, "topk": topk,
           "heads": {}}
    for size in SIZES:
        images, _, _ = resize_from_config(config)(torch.from_numpy(host["canvas"]).cuda(),
                                                  torch.from_numpy(host["hw"]).cuda(), size)
        with torch.inference_mode():
            raw = model.apply_folded(folded, images)
            kernel = lambda: postprocess_fused(raw, anchors, threshold, overlap, topk)
            plain = lambda: postprocess_raw(raw, anchors, threshold, overlap, topk)
            times = {"plain": [], "kernel": []}
            for name, fn in (("plain", plain), ("kernel", kernel), ("kernel", kernel),
                             ("plain", plain)):
                times[name] += event_ms(fn, REPS)
            res = kernel()
            want = plain()
            same = bool(torch.equal(res.keep, want.keep))
            det = decode(raw, anchors)
            longest = int((det.conf > threshold).sum(1).max().item())
            n, c = det.conf.shape[1], det.conf.shape[2]
            picks = int(res.keep.sum())
            dev, how = device_us(kernel, "postprocess_fused", calls=20)
        out["heads"][str(size)] = {
            "shape": list(raw.shape), "dtype": str(raw.dtype).replace("torch.", ""),
            "ms": float(np.median(times["kernel"])), "plain_ms": float(np.median(times["plain"])),
            "device_us": dev, "device_how": how, "picks": picks, "longest_row": longest,
            "keep_equal_plain": same,
            **bound(nbytes(raw, anchors, *res), decode_nms_ops(n, picks, raw.shape[0], c))}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
