"""Entry point of the port's flagship path — counterpart of
``__graft_entry__.py::entry``.

``entry()`` returns ``(fn, (folded, images))``: fused inference (forward →
decode → per-class NMS) on Darknet-19 YOLOv2 at 416×416 in bf16, with VOC's
20 classes and anchors, weights drawn from ``torch.Generator().manual_seed(0)``
and BN folded; ``images`` is a zero batch of 8.  Everything lives on
``device`` (the card unless the caller names another).  ``dryrun_multichip``,
the multi-device train step, waits for data-parallel training.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .category import load_anchors_file
from .models.darknet import Darknet
from .models.inference import Inference
from .ops.postprocess import postprocess

__all__ = ["entry", "flagship"]

ANCHORS = Path(__file__).resolve().parents[1] / "config" / "anchors" / "voc.tsv"


def flagship(num_classes: int = 20, dtype=torch.bfloat16) -> Darknet:
    """Darknet-19 YOLOv2 with VOC's anchors and ``pallas = nms fusedpost``."""
    return Darknet(anchors=load_anchors_file(str(ANCHORS)), num_classes=num_classes, dtype=dtype,
                   pallas=frozenset({"nms", "fusedpost"}))


def entry(device="cuda"):
    """(fn, (folded, images)): forward → decode → postprocess(threshold 0.005,
    overlap 0.45, topk 100) on Darknet-19 at 416, a batch of 8 zero images."""
    model = flagship()
    params, state = model.init(torch.Generator().manual_seed(0), device)
    inference = Inference(model)
    folded = inference.fold(params, state)

    def fn(folded, images):
        det = inference(folded, images)
        return postprocess(det, threshold=0.005, overlap=0.45, topk=100)

    images = torch.zeros((8, 416, 416, 3), dtype=torch.float32, device=device)
    return fn, (folded, images)
