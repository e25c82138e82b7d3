"""Per-class threshold + greedy NMS — counterpart of
``yolojax/ops/postprocess.py``.

The JAX package's ``vmap(classes) ∘ vmap(batch)`` becomes the leading
``(B, C)`` dims of one batched :func:`~yolojax_torch.ops.nms.nms_select`.
This is also the plain version of the fused decode+NMS CUDA kernel
(``kernels/postprocess_fused.py``) and of the batched NMS kernel's
postprocess (``kernels/nms.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .decode import Detections, decode
from .nms import nms_select

__all__ = ["PostProcessed", "postprocess", "postprocess_raw"]


class PostProcessed(NamedTuple):
    """Fixed-shape per-class detections. B=batch, C=classes, K=topk.
    Slots with ``keep`` False are don't-care."""

    yx_min: torch.Tensor  # (B, C, K, 2)
    yx_max: torch.Tensor  # (B, C, K, 2)
    conf: torch.Tensor    # (B, C, K) descending
    keep: torch.Tensor    # (B, C, K) bool — survived threshold + NMS


def postprocess(det: Detections, threshold: float, overlap: float, topk: int,
                select=nms_select) -> PostProcessed:
    """Per-class threshold + NMS on decoded detections (B, N, ·).  ``select``
    is the batched NMS: the plain one, or the kernel's wrapper
    ``kernels/nms.py::nms_select``, which ``postprocess_nms`` passes."""
    yx_min, yx_max = det.yx_min[:, None], det.yx_max[:, None]     # (B, 1, N, 2)
    idx, conf, keep = select(yx_min, yx_max, det.conf.transpose(1, 2), threshold, overlap, topk)
    take = lambda v: torch.take_along_dim(v, idx.long()[..., None], dim=2)
    return PostProcessed(take(yx_min), take(yx_max), conf, keep)


def postprocess_raw(raw: torch.Tensor, anchors, threshold: float, overlap: float,
                    topk: int) -> PostProcessed:
    """decode + postprocess in one call."""
    return postprocess(decode(raw, anchors), threshold, overlap, topk)
