"""COCO's 80 classes through detect, the fused post-processing against the
separate one — counterpart of ``scripts/c80_fusedpost.py``.

    python -m yolojax_torch.tools.c80_fusedpost [--batches 64 128] [--iters 10]
        [--size 416] [--device cuda]

Darknet-19 at 416 in bf16 with 80 classes (``entry.flagship(num_classes=80)``,
seeded weights, BN folded), the objectness logit at −6 (a trained
detector's candidate density, as ``bench.py`` sets it), threshold 0.005,
overlap 0.45, topk 100, on a seeded uniform batch of each size in
``--batches``.  Two routes of ``Inference.detect_fn``:

* fused (``pallas = nms fusedpost``): the forward, then the fused decode+NMS
  kernel (``kernels/postprocess_fused.py``);
* separate (``pallas = nms``): the forward, the decode, then the batched NMS
  kernel (``kernels/nms.py::postprocess_nms`` → ``nms_select``).

For each route and batch: the first call's wall time (the kernel's build
where it is not built yet and cuDNN's choice of algorithms for the shape,
the counterpart of the script's compile-and-first-call time), then ms and
images/s over ``--iters`` eager calls between two synchronizes (as
``tools/bench.py`` times them), the wrapper launches a call, and the
route's post-processing kernel alone on the batch's head: its one-call time
(CUDA events, 3 warm-up calls, median of 7), its device time
(``torch.profiler``, the median of the kernel's recorded events over 5
calls, CUDA events around one call where it recorded none) and its bound
on this head, all three read as ``tools/kernel_timing.py`` reads them.
Then whether the two routes kept the same boxes:
the kept count of each, whether ``keep`` is equal slot for slot, and the
largest difference of ``conf`` and of a corner over the slots both keep,
on the batch as timed and once more with the weights' own objectness logit
(about 0): at −6 a fresh 80-class head leaves no score over the threshold,
so the first comparison holds no box.

Prints a line per measurement, then one JSON line with all of it and the
card's name and power limit (``cpu`` under ``--device cpu``, where the
device times are null: not measured).  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..entry import flagship
from ..models.inference import Inference
from .bench import card
from .kernel_timing import bound, decode_nms_ops, device_us, nbytes, one_call_ms

__all__ = ["CLASSES", "ROUTES", "setup", "measure", "compare_routes", "main"]

CLASSES = 80
THRESHOLD, OVERLAP, TOPK = 0.005, 0.45, 100
OBJECTNESS = -6.0
ROUTES = {"fused": frozenset({"nms", "fusedpost"}), "separate": frozenset({"nms"})}
KERNELS = {"fused": "postprocess_fused", "separate": "nms_select"}
REPS = 7                    # one-call times a post kernel, after 3 warm calls
PROFILED = 5                # calls under torch.profiler for its device time


def setup(device, dtype=torch.bfloat16, params=None, state=None, objectness=OBJECTNESS):
    """``(model, folded, routes)``: the 80-class Darknet-19 from
    ``torch.Generator().manual_seed(0)`` (or ``params`` and ``state`` in the
    port's layout), its objectness logit at ``objectness`` (None keeps the
    weights'), folded on ``device``; ``routes`` maps "fused" and "separate"
    to ``detect_fn`` closures ``(folded, images) → PostProcessed`` built
    under each route's tokens."""
    model = flagship(num_classes=CLASSES, dtype=dtype)
    if params is None:
        params, state = model.init(torch.Generator().manual_seed(0), device)
    else:
        params = {k: {n: v.to(device) for n, v in lp.items()} for k, lp in params.items()}
        state = {k: {n: v.to(device) for n, v in lp.items()} for k, lp in state.items()}
    if objectness is not None:
        b = params["out"]["b"].clone()
        b.view(-1, 5 + CLASSES)[:, 4] = objectness
        params = dict(params, out=dict(params["out"], b=b))
    inference = Inference(model)
    folded = inference.fold(params, state)
    routes = {}
    for name, tokens in ROUTES.items():
        model.pallas = tokens          # detect_fn reads the tokens when it is built
        routes[name] = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
    model.pallas = ROUTES["fused"]     # the flagship's
    return model, folded, routes


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counts() -> dict:
    from ..kernels.nms import nms_select
    from ..kernels.postprocess_fused import postprocess_fused

    return {"postprocess_fused": postprocess_fused.launches, "nms_select": nms_select.launches}


def post_kernel(route: str, model, folded, images):
    """The route's post-processing kernel alone on the batch's head: a
    closure of one call, and its bound on this head (which counts this
    head's picks)."""
    from ..kernels.nms import nms_select
    from ..kernels.postprocess_fused import postprocess_fused
    from ..ops.decode import decode

    with torch.inference_mode():
        raw = model.apply_folded(folded, images)
        anchors = torch.as_tensor(model.anchors, dtype=torch.float32, device=raw.device)
        n = raw.shape[1] * raw.shape[2] * len(model.anchors)
        if route == "fused":
            fn = lambda: postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
            out = fn()
            return fn, bound(nbytes(raw, anchors, *out),
                             decode_nms_ops(n, int(out.keep.sum()), raw.shape[0], CLASSES))
        det = decode(raw, anchors)
        args = (det.yx_min[:, None], det.yx_max[:, None], det.conf.transpose(1, 2),
                THRESHOLD, OVERLAP, TOPK)
        fn = lambda: nms_select(*args)
        picks = fn()
        return fn, bound(nbytes(*args[:3], *picks), decode_nms_ops(n, int(picks[2].sum())))


def measure(route: str, run, model, folded, images, iters: int) -> tuple[dict, object]:
    """``run``, the ``route`` closure of :func:`setup`, at one batch: the
    first call, ``iters`` timed calls, the wrapper launches a call, and the
    route's post kernel alone.  Returns (numbers, the first call's output)."""
    device, batch = images.device, images.shape[0]
    t0 = time.perf_counter()
    out = run(folded, images)
    _sync(device)
    first_s = time.perf_counter() - t0
    run(folded, images)
    _sync(device)
    before = _counts()
    t0 = time.perf_counter()
    for _ in range(iters):
        run(folded, images)
    _sync(device)
    ms = (time.perf_counter() - t0) / iters * 1e3
    launches = {k: (v - before[k]) / iters for k, v in _counts().items()}
    fn, post_bound = post_kernel(route, model, folded, images)
    with torch.inference_mode():
        post_ms = one_call_ms(fn, device, REPS)
        dev_us, how = (device_us(fn, KERNELS[route], PROFILED) if device.type == "cuda"
                       else (None, "not measured: no card"))
    return {"first_s": first_s, "ms": ms, "img_per_s": batch / ms * 1e3,
            "launches_per_call": launches, "post_kernel": KERNELS[route], "post_ms": post_ms,
            "post_device_us": dev_us, "post_device_how": how, **post_bound}, out


def compare_routes(fused, separate) -> dict:
    """Did the two routes keep the same boxes: each one's kept count,
    ``keep`` equal slot for slot, and the largest ``conf`` and corner gaps
    over the slots both keep."""
    both = fused.keep & separate.keep
    gap = lambda a, b: float((a.float() - b.float()).abs()[both].max()) if both.any() else 0.0
    return {"kept_fused": int(fused.keep.sum()), "kept_separate": int(separate.keep.sum()),
            "same_keep": bool(torch.equal(fused.keep, separate.keep)),
            "max_conf_diff": gap(fused.conf, separate.conf),
            "max_corner_diff": max(gap(fused.yx_min, separate.yx_min),
                                   gap(fused.yx_max, separate.yx_max))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 128])
    ap.add_argument("--iters", type=int, default=10, help="timed calls a route and batch")
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "pass --device cpu to run on the CPU")
    model, folded, routes = setup(device)
    # the same weights with the init's objectness (about 0): the routes' picks
    # on a head where scores clear the threshold
    _, dense_folded, dense_routes = setup(device, objectness=None)
    rng = np.random.default_rng(0)
    result = {"device": card(device), "size": args.size, "classes": CLASSES, "dtype": "bfloat16",
              "threshold": THRESHOLD, "overlap": OVERLAP, "topk": TOPK, "objectness": OBJECTNESS,
              "iters": args.iters, "batches": {}}
    for batch in args.batches:
        images = torch.from_numpy(rng.uniform(0, 1, (batch, args.size, args.size, 3))
                                  .astype(np.float32)).to(device)
        row, outs = {}, {}
        for route, run in routes.items():
            row[route], outs[route] = measure(route, run, model, folded, images, args.iters)
            r = row[route]
            print(f"B={batch} {route:8s} first call: {r['first_s']:6.1f} s", flush=True)
            print(f"B={batch} {route:8s} {r['ms']:7.2f} ms {r['img_per_s']:7.0f} img/s; "
                  f"{r['post_kernel']} alone {r['post_ms']:.4f} ms, device "
                  f"{r['post_device_us']} us, bound {r['bound_ms']:.5f} ms by {r['bound_by']}",
                  flush=True)
        row["same_boxes"] = compare_routes(outs["fused"], outs["separate"])
        row["same_boxes_init_objectness"] = compare_routes(
            *(dense_routes[r](dense_folded, images) for r in ("fused", "separate")))
        print(f"B={batch} same boxes: {row['same_boxes']}; with the init's objectness "
              f"{row['same_boxes_init_objectness']}", flush=True)
        result["batches"][str(batch)] = row
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
