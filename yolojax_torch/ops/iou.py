"""IoU in the repo-wide yx-corner convention — the part of
``yolojax/ops/iou.py`` that NMS needs.  Boxes are ``(yx_min, yx_max)`` pairs
of shape ``(..., 2)`` holding (y, x)."""

from __future__ import annotations

import torch

__all__ = ["area", "iou_pairwise"]

_EPS = 1e-10


def area(yx_min, yx_max):
    """Box areas; negative extents clamp to zero. Shape (...,)."""
    hw = torch.clamp(yx_max - yx_min, min=0.0)
    return hw[..., 0] * hw[..., 1]


def iou_pairwise(yx_min1, yx_max1, yx_min2, yx_max2):
    """Elementwise IoU of two broadcastable box sets, shape (...,)."""
    ymin = torch.maximum(yx_min1, yx_min2)
    ymax = torch.minimum(yx_max1, yx_max2)
    inter = area(ymin, ymax)
    union = area(yx_min1, yx_max1) + area(yx_min2, yx_max2) - inter
    return inter / torch.clamp(union, min=_EPS)
