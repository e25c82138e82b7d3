"""``detect`` command of the port: single image, video file or camera
detection (counterpart of ``yolojax/cli/detect.py``; BASELINE config 1).

Pipeline: read frame → centered gray canvas → ``[transform] resize`` to the
input size → folded forward + decode + per-class NMS → invert the resize →
draw class/conf-labelled boxes.  On the card the NMS is the fused
decode+NMS kernel (``detect_fn``); with the model on the CPU it is the native
C++ library (``detect_fn_host``) where that builds.

    python -m yolojax_torch.cli.detect IMG -c config.ini [--device cuda] [-o out.png]
    python -m yolojax_torch.cli.detect clip.avi -c config.ini -o out.avi   # video file
    python -m yolojax_torch.cli.detect 0 -c config.ini [--show]            # camera 0

cv2 reads and writes the frames and matplotlib shows them (``--show``); each
is imported only where a path needs it.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..config import get_canvas
from ..data.transform import resize_from_config
from ..models.inference import Inference, to_host
from ..native import native_nms_available
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
    (yx_min, yx_max, cls, conf) as numpy, normalized to the input image.  On
    the CPU the NMS runs in the native library where it builds
    (``detect_fn_host``), as the reference's CPU backend does; elsewhere, and
    without the library, ``detect_fn``."""
    threshold = config.getfloat("detect", "threshold", fallback=0.4)
    overlap = config.getfloat("detect", "overlap", fallback=0.45)
    topk = config.getint("detect", "topk", fallback=100)
    device = next(iter(params.values()))["w"].device
    inference = Inference(model)
    folded = inference.fold(params, state)
    if device.type == "cpu" and native_nms_available():
        run = inference.detect_fn_host(threshold, overlap, topk)
        _LOG.info("detect path: forward on the CPU, native NMS (detect_fn_host)")
    else:
        run = inference.detect_fn(threshold, overlap, topk)
        _LOG.info("detect path: detect_fn on %s", device)

    canvas, hw = _to_canvas(image, get_canvas(config))
    resize = resize_from_config(config)
    images, scale, pad = resize(torch.from_numpy(canvas[None]).to(device),
                                torch.from_numpy(hw[None]).to(device), size)
    yx_min, yx_max, conf, keep = to_host(run(folded, images))
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
    parser = make_parser("detect objects in an image, a video file or a camera stream")
    parser.add_argument("input", help="image path, video path, or an integer camera index")
    parser.add_argument("-f", "--file", default=None,
                        help="checkpoint .npz or darknet .weights "
                             "(default: latest in the model dir)")
    parser.add_argument("--size", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    parser.add_argument("-o", "--output", default=None,
                        help="output image path (a video for video or camera input)")
    parser.add_argument("--show", action="store_true", help="matplotlib display")
    args = parser.parse_args(argv)
    config = setup(args)

    category, anchors, model = build(config)
    params, state, _ = load_weights_auto(config, model, args.file,
                                         resume=args.file is None, device=args.device)
    size = args.size or int(config.get("data", "sizes").split(",")[0])

    import cv2

    def handle(frame_rgb, tag: str, write: bool = True):
        ymin, ymax, cls, conf = detect_image(config, model, params, state, frame_rgb, size)
        for i in range(len(cls)):
            _LOG.info("%s: %s %.2f @ %s %s", tag, category[cls[i]], conf[i],
                      ymin[i].round(3), ymax[i].round(3))
        drawn = draw_boxes(frame_rgb, ymin, ymax, cls, conf, category)
        if write and args.output:
            cv2.imwrite(args.output, drawn[:, :, ::-1])
            _LOG.info("wrote %s", args.output)
        if args.show:
            import matplotlib.pyplot as plt

            plt.imshow(drawn)
            plt.axis("off")
            plt.show()
        return drawn

    def run_capture(cap, tag: str) -> int:
        """Frame loop shared by the camera and video-file paths; with ``-o``
        the annotated frames are written back out as one video."""
        writer, n = None, 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                drawn = handle(frame[:, :, ::-1], f"{tag}#{n}", write=False)
                if args.output:
                    if writer is None:
                        fps = cap.get(cv2.CAP_PROP_FPS)
                        fourcc = "mp4v" if args.output.endswith(".mp4") else "MJPG"
                        writer = cv2.VideoWriter(
                            args.output, cv2.VideoWriter_fourcc(*fourcc),
                            fps if fps and fps > 0 else 25.0,
                            (drawn.shape[1], drawn.shape[0]))
                    writer.write(np.ascontiguousarray(drawn[:, :, ::-1]))
                n += 1
        finally:
            cap.release()
            if writer is not None:
                writer.release()
                _LOG.info("wrote %s (%d frames)", args.output, n)
        return n

    if args.input.isdigit():  # camera loop
        run_capture(cv2.VideoCapture(int(args.input)), "cam")
    else:
        img = cv2.imread(args.input, cv2.IMREAD_COLOR)
        if img is not None:
            handle(img[:, :, ::-1], os.path.basename(args.input))
        else:  # not an image: try it as a video container
            cap = cv2.VideoCapture(args.input)
            if not (cap.isOpened() and run_capture(cap, os.path.basename(args.input))):
                raise SystemExit(f"cannot read {args.input}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
