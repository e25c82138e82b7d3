"""IoU in the repo-wide yx-corner convention — counterpart of
``yolojax/ops/iou.py``: the torch functions, and ``np_iou_matrix``, the
numpy IoU that the host-side AP matcher (``eval_ap.py``) uses.  Boxes are
``(yx_min, yx_max)`` pairs of shape ``(..., 2)`` holding (y, x)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["area", "intersection", "iou_matrix", "iou_pairwise", "np_iou_matrix",
           "wh_iou_matrix"]

_EPS = 1e-10


def area(yx_min, yx_max):
    """Box areas; negative extents clamp to zero. Shape (...,)."""
    hw = torch.clamp(yx_max - yx_min, min=0.0)
    return hw[..., 0] * hw[..., 1]


def intersection(yx_min1, yx_max1, yx_min2, yx_max2):
    """Pairwise intersection areas: (..., N1, 2) × (..., N2, 2) → (..., N1, N2)."""
    ymin = torch.maximum(yx_min1[..., :, None, :], yx_min2[..., None, :, :])
    ymax = torch.minimum(yx_max1[..., :, None, :], yx_max2[..., None, :, :])
    return area(ymin, ymax)


def iou_matrix(yx_min1, yx_max1, yx_min2, yx_max2):
    """Pairwise IoU matrix (..., N1, N2) — the loss's ignore band."""
    inter = intersection(yx_min1, yx_max1, yx_min2, yx_max2)
    a1 = area(yx_min1, yx_max1)[..., :, None]
    a2 = area(yx_min2, yx_max2)[..., None, :]
    return inter / torch.clamp(a1 + a2 - inter, min=_EPS)


def iou_pairwise(yx_min1, yx_max1, yx_min2, yx_max2):
    """Elementwise IoU of two broadcastable box sets, shape (...,)."""
    ymin = torch.maximum(yx_min1, yx_min2)
    ymax = torch.minimum(yx_max1, yx_max2)
    inter = area(ymin, ymax)
    union = area(yx_min1, yx_max1) + area(yx_min2, yx_max2) - inter
    return inter / torch.clamp(union, min=_EPS)


def wh_iou_matrix(hw1, hw2):
    """Shape-only IoU of (h, w) pairs, both boxes centered at the origin:
    (..., N1, 2) × (..., N2, 2) → (..., N1, N2).  The loss's anchor match."""
    inter = torch.minimum(hw1[..., :, None, :], hw2[..., None, :, :])
    inter = inter[..., 0] * inter[..., 1]
    a1 = (hw1[..., 0] * hw1[..., 1])[..., :, None]
    a2 = (hw2[..., 0] * hw2[..., 1])[..., None, :]
    return inter / torch.clamp(a1 + a2 - inter, min=_EPS)


def np_iou_matrix(yx_min1, yx_max1, yx_min2, yx_max2):
    """Pairwise IoU matrix in numpy (..., N1, N2), for host-side matching."""
    ymin = np.maximum(yx_min1[..., :, None, :], yx_min2[..., None, :, :])
    ymax = np.minimum(yx_max1[..., :, None, :], yx_max2[..., None, :, :])
    hw = np.maximum(ymax - ymin, 0.0)
    inter = hw[..., 0] * hw[..., 1]
    hw1 = np.maximum(yx_max1 - yx_min1, 0.0)
    hw2 = np.maximum(yx_max2 - yx_min2, 0.0)
    a1 = (hw1[..., 0] * hw1[..., 1])[..., :, None]
    a2 = (hw2[..., 0] * hw2[..., 1])[..., None, :]
    return inter / np.maximum(a1 + a2 - inter, _EPS)
