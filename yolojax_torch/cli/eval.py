"""``eval`` command of the port: mAP over the cached val/test split
(counterpart of ``yolojax/cli/eval.py``).

    python -m yolojax_torch.cli.eval -c config.ini [more.ini …] [-f CKPT.npz | X.weights]
        [--size 416] [--batch 16] [--results dets.jsonl] [--device cuda]
    torchrun --nproc_per_node N -m yolojax_torch.cli.eval -c config.ini …   # N cards

Per batch: the loader's host canvases → the device → ``[transform] resize``
→ folded forward + decode + per-class NMS (``Inference.detect_fn``: the
fused decode+NMS kernel under the default ``pallas = nms fusedpost``) → the
fixed-size ``PostProcessed`` back to the host in one copy (``to_host``) →
the resize inverted in float32 numpy → the VOC-protocol AP (or COCO's, with
``[eval] protocol = coco``).

Across ranks (the group of ``parallel/collectives.py::init_from_env``), as
the JAX package's ``detect_fn(mesh=…)`` splits the batch over devices: each
rank runs ``detect_fn`` on its contiguous share of every global batch (the
final partial batch padded by repeating its last row), brings its picks to
the host, and rank 0 gathers them in rank order, fills the recorder and
computes the AP, which every rank returns.  Every rank decodes the whole
batch on the host; rank 0 alone writes the results.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from .. import config as _config
from ..data.cache import load_cache
from ..data.dataset import Dataset, _imread_rgb
from ..data.loader import Loader
from ..data.transform import resize_from_config
from ..eval_ap import DetectionRecorder, evaluate, evaluate_coco
from ..models.inference import Inference, to_host
from ..parallel.collectives import (broadcast_from_rank0, gather_to_rank0, init_from_env, rank,
                                    world)
from ..utils.metrics import Meter, Summary
from . import make_parser, setup
from .common import build, load_weights_auto

_LOG = logging.getLogger(__name__)


def _picks(out, rows: int, hw, scale, pad, size: int) -> list[list]:
    """The kept detections of the first ``rows`` images of a host
    ``PostProcessed``, the resize inverted to each original image's
    normalized coords: per image, ``[(class, yx_min, yx_max, conf), …]``."""
    per_image = []
    for b in range(rows):
        dets = []
        for c in range(out.keep.shape[1]):
            keep = out.keep[b, c]
            if not keep.any():
                continue
            dmin = (out.yx_min[b, c][keep] * size - pad[b]) / scale[b] / hw[b]
            dmax = (out.yx_max[b, c][keep] * size - pad[b]) / scale[b] / hw[b]
            dets.append((c, np.clip(dmin, 0, 1), np.clip(dmax, 0, 1), out.conf[b, c][keep]))
        per_image.append(dets)
    return per_image


def run_eval(config, model, params, state, records, size: int, batch_size: int,
             category, imread=_imread_rgb, group=None) -> dict:
    """Evaluate the folded model's mAP over ``records`` on the device that
    ``params`` live on; returns {'map', 'ap', 'rate', 'recorder'} (and
    'map_50', 'map_75' under the COCO protocol).  ``imread`` decodes one
    record's image (cv2 by default).  With ``group``, ``batch_size`` is the
    global batch, split evenly over the ranks (see the module docstring),
    and every rank returns rank 0's result."""
    n_ranks = world(group)
    if group is None and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError("WORLD_SIZE > 1 but run_eval got no group: pass the one "
                           "parallel.collectives.init_from_env returns")
    if batch_size % n_ranks:
        raise ValueError(f"eval batch {batch_size} does not split over {n_ranks} ranks")
    share = batch_size // n_ranks
    lo = rank(group) * share
    threshold = config.getfloat("eval", "threshold", fallback=0.005)
    overlap = config.getfloat("eval", "overlap", fallback=0.45)
    topk = config.getint("eval", "topk", fallback=300)
    iou = config.getfloat("eval", "iou", fallback=0.5)
    use07 = config.getboolean("eval", "metric07", fallback=True)

    device = next(iter(params.values()))["w"].device
    inference = Inference(model)
    folded = inference.fold(params, state)
    detect = inference.detect_fn(threshold, overlap, topk)

    dataset = Dataset(records, canvas=_config.get_canvas(config),
                      max_boxes=config.getint("data", "max_boxes", fallback=60), imread=imread)
    loader = Loader(dataset, batch_size, workers=config.getint("data", "workers", fallback=3),
                    shuffle=False, drop_last=False)
    recorder = DetectionRecorder(len(category))
    meter = Meter()
    resize = resize_from_config(config)

    for batch in loader.epoch():
        n = len(batch["hw"])
        if n < batch_size:
            # pad the final partial batch with its last row: one shape for
            # every batch (one layout of the fused kernel) and an even split
            # over the ranks; the padded rows are not read back
            batch = {k: np.concatenate([v, np.repeat(v[-1:], batch_size - n, axis=0)])
                     for k, v in batch.items()}
        mine = slice(lo, lo + share)
        images, scale, pad = resize(torch.from_numpy(batch["canvas"][mine]).to(device),
                                    torch.from_numpy(batch["hw"][mine]).to(device), size)
        out = to_host(detect(folded, images))
        picks = _picks(out, min(max(n - lo, 0), share), batch["hw"][mine],
                       scale.cpu().numpy(), pad.cpu().numpy(), size)
        gathered = gather_to_rank0(picks, group)
        if gathered is None:
            continue
        meter.mark(n)
        for b, dets in enumerate(d for rank_picks in gathered for d in rank_picks):
            idx = int(batch["index"][b])
            valid = batch["valid"][b]
            recorder.add_ground_truth(idx, batch["yx_min"][b][valid], batch["yx_max"][b][valid],
                                      batch["cls"][b][valid], batch["difficult"][b][valid])
            for c, dmin, dmax, conf in dets:
                recorder.add_detections(idx, dmin, dmax, conf, np.full(len(conf), c))
    result = None
    if rank(group) == 0:
        # [eval] protocol = voc (default) | coco: AP@[.5:.95] with 101-point
        # interpolation and crowd-ignore matching; "map" is the headline either way
        if config.get("eval", "protocol", fallback="voc") == "coco":
            result = evaluate_coco(recorder)
            result["ap"] = result["ap"][0.5]  # per-class table shown at IoU 0.5
        else:
            result = evaluate(recorder, iou_threshold=iou, use_07_metric=use07)
        result["rate"] = meter.rate
        result["recorder"] = recorder
    return broadcast_from_rank0(result, group)


def main(argv=None):
    parser = make_parser("evaluate mAP on the cached val/test split")
    parser.add_argument("-f", "--file", default=None,
                        help="checkpoint .npz or darknet .weights (default: latest)")
    parser.add_argument("--size", type=int, default=None, help="eval input size")
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--results", default=None, metavar="PATH",
                        help="also write every detection as jsonl")
    parser.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    args = parser.parse_args(argv)
    config = setup(args)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch sees no CUDA device; "
                           "pass --device cpu to evaluate on the CPU")

    group, device = init_from_env(args.device)
    category, anchors, model = build(config)
    params, state, meta = load_weights_auto(config, model, args.file, resume=args.file is None,
                                            device=device)
    phase = config.get("eval", "phase", fallback="test")
    records = load_cache(config, phase)
    size = args.size or int(config.get("data", "sizes").split(",")[0])
    batch_size = args.batch or config.getint("eval", "batch_size", fallback=16)

    t0 = time.time()
    result = run_eval(config, model, params, state, records, size, batch_size, category,
                      group=group)
    if rank(group) != 0:          # rank 0 logs and writes
        return 0
    for c, ap in sorted(result["ap"].items()):
        _LOG.info("AP %-16s %.4f", category[c], ap)
    if "map_50" in result:
        _LOG.info("AP@[.5:.95] = %.4f  AP50 = %.4f  AP75 = %.4f  "
                  "(%d images, %.1f img/s, %.1fs)", result["map"],
                  result["map_50"], result["map_75"], len(records),
                  result["rate"], time.time() - t0)
    else:
        _LOG.info("mAP@%.2f = %.4f  (%d images, %.1f img/s, %.1fs)",
                  config.getfloat("eval", "iou", fallback=0.5), result["map"],
                  len(records), result["rate"], time.time() - t0)

    if args.results:
        with open(args.results, "w") as f:
            for c, dets in result["recorder"].dets.items():
                for img, conf, dmin, dmax in dets:
                    f.write(json.dumps({
                        "image": int(img), "category": category[c],
                        "conf": round(conf, 5),
                        "yx_min": [round(float(v), 5) for v in dmin],
                        "yx_max": [round(float(v), 5) for v in dmax]}) + "\n")
        _LOG.info("wrote detections to %s", args.results)

    # the mAP scalar at the checkpoint's step, mirrored to scalars.jsonl
    summary = Summary(_config.get_model_dir(config), config)
    summary.scalar(int(meta.get("step", 0) or 0),
                   **{"eval/mAP": result["map"], "eval/size": size})
    summary.close()

    db = _config.get_eval_db(config)
    os.makedirs(os.path.dirname(db), exist_ok=True)
    with open(db, "a") as f:
        row = {"time": time.time(), "size": size, "map": result["map"],
               "ap": {category[c]: v for c, v in result["ap"].items()}}
        if "map_50" in result:  # coco protocol: record the sub-metrics too
            row["map_50"], row["map_75"] = result["map_50"], result["map_75"]
        f.write(json.dumps(row) + "\n")
    print(f"mAP = {result['map']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
