"""Greedy NMS by argmax iteration — counterpart of
``yolojax/ops/nms.py::nms_select``.

Each round emits the highest remaining score of every active row and
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

from .iou import iou_pairwise

__all__ = ["nms_select"]


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

