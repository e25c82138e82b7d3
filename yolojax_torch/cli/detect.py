"""``detect`` command of the port: single-image detection (counterpart of
``yolojax/cli/detect.py``; camera and video input are not ported yet).

Pipeline: read image → centered gray canvas → ``[transform] resize`` to the
input size → folded forward + fused decode/NMS → invert the resize → draw
class/conf-labelled boxes.

    python -m yolojax_torch.cli.detect IMG -c config.ini [--device cuda] [-o out.png]
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..config import get_canvas
from ..data.transform import resize_from_config
from ..models.inference import Inference
from ..utils.visualize import draw_boxes
from . import make_parser, setup
from .common import build, load_weights_auto

_LOG = logging.getLogger(__name__)

GRAY = 127  # canvas fill, as yolojax.data.dataset.GRAY


def _to_canvas(img: np.ndarray, canvas: int):
    h, w = img.shape[:2]
    if max(h, w) > canvas:
        import cv2

        s = canvas / max(h, w)
        img = cv2.resize(img, (max(1, int(w * s)), max(1, int(h * s))),
                         interpolation=cv2.INTER_AREA)
        h, w = img.shape[:2]
    out = np.full((canvas, canvas, 3), GRAY, np.uint8)
    oy, ox = (canvas - h) // 2, (canvas - w) // 2
    out[oy:oy + h, ox:ox + w] = img
    return out, np.asarray([h, w], np.float32)


def detect_image(config, model, params, state, image: np.ndarray, size: int):
    """Run detection on one RGB uint8 image on the device ``params`` live on →
    (yx_min, yx_max, cls, conf) as numpy, normalized to the input image."""
    threshold = config.getfloat("detect", "threshold", fallback=0.4)
    overlap = config.getfloat("detect", "overlap", fallback=0.45)
    topk = config.getint("detect", "topk", fallback=100)
    device = next(iter(params.values()))["w"].device
    inference = Inference(model)
    folded = inference.fold(params, state)
    run = inference.detect_fn(threshold, overlap, topk)

    canvas, hw = _to_canvas(image, get_canvas(config))
    resize = resize_from_config(config)
    images, scale, pad = resize(torch.from_numpy(canvas[None]).to(device),
                                torch.from_numpy(hw[None]).to(device), size)
    out = [t.cpu().numpy() for t in run(folded, images)]
    yx_min, yx_max, conf, keep = out
    scale, pad = scale[0].cpu().numpy(), pad[0].cpu().numpy()

    boxes_min, boxes_max, cls, confs = [], [], [], []
    for c in range(conf.shape[1]):
        k = keep[0, c]
        if not k.any():
            continue
        dmin = (yx_min[0, c][k] * size - pad) / scale / hw
        dmax = (yx_max[0, c][k] * size - pad) / scale / hw
        boxes_min.append(np.clip(dmin, 0, 1))
        boxes_max.append(np.clip(dmax, 0, 1))
        cls.extend([c] * int(k.sum()))
        confs.extend(conf[0, c][k].tolist())
    if not cls:
        return (np.zeros((0, 2)), np.zeros((0, 2)),
                np.zeros((0,), np.int32), np.zeros((0,)))
    return (np.concatenate(boxes_min), np.concatenate(boxes_max),
            np.asarray(cls, np.int32), np.asarray(confs))


def main(argv=None):
    parser = make_parser("detect objects in an image")
    parser.add_argument("input", help="image path")
    parser.add_argument("-f", "--file", default=None,
                        help="checkpoint .npz (default: latest in the model dir)")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    parser.add_argument("-o", "--output", default=None, help="output image path")
    args = parser.parse_args(argv)
    config = setup(args)

    category, anchors, model = build(config)
    params, state, _ = load_weights_auto(config, model, args.file,
                                         resume=args.file is None, device=args.device)
    size = args.size or int(config.get("data", "sizes").split(",")[0])

    import cv2

    img = cv2.imread(args.input, cv2.IMREAD_COLOR)
    if img is None:
        raise SystemExit(f"cannot read {args.input} as an image "
                         "(camera and video input are not ported yet)")
    rgb = img[:, :, ::-1]
    ymin, ymax, cls, conf = detect_image(config, model, params, state, rgb, size)
    tag = os.path.basename(args.input)
    for i in range(len(cls)):
        _LOG.info("%s: %s %.2f @ %s %s", tag, category[cls[i]], conf[i],
                  ymin[i].round(3), ymax[i].round(3))
    if args.output:
        drawn = draw_boxes(rgb, ymin, ymax, cls, conf, category)
        cv2.imwrite(args.output, drawn[:, :, ::-1])
        _LOG.info("wrote %s", args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
