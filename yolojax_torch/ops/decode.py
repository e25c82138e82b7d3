"""Region head decode — counterpart of ``yolojax/ops/decode.py``.

The head is NHWC ``(B, H, W, A*(5+C))`` with per-anchor channels
``[ty, tx, th, tw, to, cls...]`` — already in yx order (the darknet importer
permutes at import time), so nothing is swapped here::

    center_yx = (sigmoid(t_yx) + grid_offset_yx) / (H, W)
    size_hw   = anchor_hw * exp(clip(t_hw, ±12)) / (H, W)
    conf      = sigmoid(t_o) * softmax(t_cls)

Candidates are flattened as ``n = (y*W + x)*A + a``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["decode", "Detections"]


class Detections(NamedTuple):
    """Decoded head output, flattened over cells×anchors (N = H*W*A)."""

    yx_min: torch.Tensor  # (B, N, 2) normalized corners
    yx_max: torch.Tensor  # (B, N, 2)
    iou: torch.Tensor     # (B, N) objectness
    prob: torch.Tensor    # (B, N, C) class probabilities
    conf: torch.Tensor    # (B, N, C) = iou * prob


def decode(raw: torch.Tensor, anchors) -> Detections:
    """Decode raw head output against (A, 2) anchor (h, w) pairs in grid units."""
    b, h, w, ch = raw.shape
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=raw.device)
    a = anchors.shape[0]
    x = raw.float().reshape(b, h, w, a, ch // a)
    t_yx, t_hw, t_o, t_cls = x[..., :2], x[..., 2:4], x[..., 4], x[..., 5:]

    off_y = torch.arange(h, dtype=torch.float32, device=raw.device)[:, None].expand(h, w)
    off_x = torch.arange(w, dtype=torch.float32, device=raw.device)[None, :].expand(h, w)
    offset = torch.stack([off_y, off_x], dim=-1)[None, :, :, None, :]  # (1,H,W,1,2)
    scale = torch.tensor([h, w], dtype=torch.float32, device=raw.device)

    center = (torch.sigmoid(t_yx) + offset) / scale
    size = anchors * torch.exp(torch.clamp(t_hw, -12.0, 12.0)) / scale
    half = size * 0.5
    yx_min = center - half
    yx_max = center + half

    iou = torch.sigmoid(t_o)
    prob = torch.softmax(t_cls, dim=-1)
    conf = iou[..., None] * prob

    n = h * w * a
    return Detections(
        yx_min=yx_min.reshape(b, n, 2),
        yx_max=yx_max.reshape(b, n, 2),
        iou=iou.reshape(b, n),
        prob=prob.reshape(b, n, -1),
        conf=conf.reshape(b, n, -1),
    )
