"""Greedy NMS — counterpart of ``yolojax/ops/nms.py``.

:func:`nms_select` is greedy NMS by argmax iteration, the production path;
:func:`nms_mask` is the keep-mask formulation over a fixed candidate set
(sort, then one pass in score order), aligned to the input order; and
:func:`nms_topk` preselects the top ``topk`` scores and masks them.

In :func:`nms_select` each round emits the highest remaining score of every active row and
suppresses its neighbours with one IoU row; a row stops when its peak score
is no longer ``> threshold`` or ``max_out`` picks are out.  The rows (leading
dims) run together, one round per loop step, as the JAX package's vmapped
while-loop does.  Semantics: strict ``> threshold``, suppress ``iou >
overlap``, the pick always suppresses itself (a zero-area box has IoU 0 with
everything), ties go to the lowest index (``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does).
"""

from __future__ import annotations

import math

import torch

from .iou import iou_matrix, iou_pairwise

__all__ = ["nms_select", "nms_mask", "nms_topk"]


def nms_select(yx_min, yx_max, scores, threshold: float, overlap: float, max_out: int):
    """Greedy NMS over the last axis → top ``max_out`` picks, score order.

    yx_min / yx_max (..., N, 2), broadcastable against scores (..., N) →
    (idx int32, conf f32, valid bool), each (..., max_out).
    """
    lead, n = scores.shape[:-1], scores.shape[-1]
    g = math.prod(lead)
    s = scores.float().reshape(g, n).clone()
    ymin = yx_min.broadcast_to(*lead, n, 2).reshape(g, n, 2)
    ymax = yx_max.broadcast_to(*lead, n, 2).reshape(g, n, 2)
    rows = torch.arange(g, device=s.device)
    lane = torch.arange(n, device=s.device)
    idx = torch.zeros((g, max_out), dtype=torch.int64, device=s.device)
    conf = torch.zeros((g, max_out), dtype=torch.float32, device=s.device)
    count = torch.zeros(g, dtype=torch.int64, device=s.device)
    m = s.amax(dim=1)
    for k in range(max_out):
        act = m > threshold              # a row that stops never restarts
        if not bool(act.any()):
            break
        i = s.argmax(dim=1)
        iou = iou_pairwise(ymin[rows, i][:, None], ymax[rows, i][:, None], ymin, ymax)
        idx[:, k] = torch.where(act, i, 0)
        conf[:, k] = torch.where(act, m, 0.0)
        hit = (iou > overlap) | (lane[None, :] == i[:, None])
        s = torch.where(act[:, None] & hit, -math.inf, s)
        m = s.amax(dim=1)
        count += act
    valid = torch.arange(max_out, device=s.device) < count[:, None]
    shape = (*lead, max_out)
    return idx.to(torch.int32).reshape(shape), conf.reshape(shape), valid.reshape(shape)



def nms_mask(yx_min, yx_max, scores, overlap: float, valid=None) -> torch.Tensor:
    """Greedy NMS keep-mask over N boxes: (N, 2), (N, 2), (N,) → bool (N,).

    A box is suppressed by any *kept* higher-scoring box with IoU >
    ``overlap``; ``valid`` masks out padding or below-threshold candidates.
    Scores are visited in descending order, equal scores lowest index first
    (a stable sort, as ``jnp.argsort``).
    """
    n = scores.shape[0]
    valid = (torch.ones(n, dtype=torch.bool, device=scores.device) if valid is None
             else valid.to(torch.bool))
    order = torch.argsort(-scores, stable=True)
    ymin, ymax, v = yx_min[order], yx_max[order], valid[order]
    suppress = iou_matrix(ymin, ymax, ymin, ymax) > overlap
    keep = torch.zeros(n, dtype=torch.bool, device=scores.device)
    for i in range(n):
        # box i is kept iff valid and no kept earlier box suppresses it
        keep[i] = v[i] & ~(keep[:i] & suppress[:i, i]).any()
    out = torch.empty_like(keep)
    out[order] = keep
    return out


def nms_topk(yx_min, yx_max, scores, threshold: float, overlap: float, topk: int):
    """Top-K preselect + greedy NMS: (N, 2), (N, 2), (N,) → (yx_min, yx_max,
    scores, keep), each of leading dim K = min(topk, N), in descending score
    order with equal scores lowest index first (as ``jax.lax.top_k``);
    ``keep`` is False for suppressed boxes and for scores not ``>
    threshold``."""
    k = min(topk, scores.shape[0])
    top_scores, idx = torch.sort(scores, descending=True, stable=True)
    top_scores, idx = top_scores[:k], idx[:k]
    ymin, ymax = yx_min[idx], yx_max[idx]
    keep = nms_mask(ymin, ymax, top_scores, overlap, top_scores > threshold)
    return ymin, ymax, top_scores, keep
