"""Anchor estimation: IoU-distance k-means "dimension clusters" — a copy of
``yolojax/tools/kmeans.py`` (plain numpy).

k-means over cached ground-truth (h, w) pairs with distance
``d = 1 − IoU(box, centroid)`` (boxes centered at the origin), seeded with
``np.random.default_rng``; emits the anchors tsv that ``category.get_anchors``
reads.
"""

from __future__ import annotations

import numpy as np

__all__ = ["kmeans_anchors", "collect_hw"]


def _wh_iou(hw: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Shape-only IoU matrix (N, K), boxes centered at the origin."""
    inter = np.minimum(hw[:, None, :], centroids[None, :, :]).prod(-1)
    union = hw.prod(-1)[:, None] + centroids.prod(-1)[None, :] - inter
    return inter / np.maximum(union, 1e-10)


def kmeans_anchors(hw: np.ndarray, k: int, iters: int = 100, seed: int = 0,
                   tol: float = 1e-6) -> tuple[np.ndarray, float]:
    """k-means with d = 1 − IoU → (anchors (k, 2) sorted by area, mean IoU)."""
    hw = np.asarray(hw, np.float64)
    rng = np.random.default_rng(seed)
    centroids = hw[rng.choice(len(hw), size=k, replace=False)]
    assign = None
    for _ in range(iters):
        iou = _wh_iou(hw, centroids)
        new_assign = iou.argmax(1)
        if assign is not None and np.array_equal(new_assign, assign):
            break
        assign = new_assign
        for j in range(k):
            sel = assign == j
            if sel.any():
                centroids[j] = hw[sel].mean(0)
            else:  # dead centroid: reseed on the farthest box
                centroids[j] = hw[iou.max(1).argmin()]
    mean_iou = float(_wh_iou(hw, centroids).max(1).mean())
    order = np.argsort(centroids.prod(-1))
    return centroids[order].astype(np.float32), mean_iou


def collect_hw(records: list[dict], grid: float) -> np.ndarray:
    """Ground-truth (h, w) in grid-cell units from cached records."""
    hw = [(r["yx_max"] - r["yx_min"]) * grid for r in records if len(r["cls"])]
    return np.concatenate(hw, axis=0)
