"""Region head decode — counterpart of ``yolojax/ops/decode.py``.

The head is NHWC ``(B, H, W, A*(5+C))`` with per-anchor channels
``[ty, tx, th, tw, to, cls...]`` — already in yx order (the darknet importer
permutes at import time), so nothing is swapped here::

    center_yx = (sigmoid(t_yx) + grid_offset_yx) / (H, W)
    size_hw   = anchor_hw * exp(clip(t_hw, ±12)) / (H, W)
    conf      = sigmoid(t_o) * softmax(t_cls)

Candidates are flattened as ``n = (y*W + x)*A + a``.  The softmax is the
reference's op order (``yolojax/kernels/nms.py::_fused_kernel``): max,
exp(x − max), the denominator summed in class order, a real division.  The
fused CUDA kernel computes the same, so the two give the same scores bit for
bit on the card; ``torch.softmax`` sums in an order of its own (a warp tree
on CUDA), an ulp apart, and greedy NMS then takes near-equal scores in
another order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["decode", "Detections", "softmax_in_class_order"]


class Detections(NamedTuple):
    """Decoded head output, flattened over cells×anchors (N = H*W*A)."""

    yx_min: torch.Tensor  # (B, N, 2) normalized corners
    yx_max: torch.Tensor  # (B, N, 2)
    iou: torch.Tensor     # (B, N) objectness
    prob: torch.Tensor    # (B, N, C) class probabilities
    conf: torch.Tensor    # (B, N, C) = iou * prob


def softmax_in_class_order(t: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, its denominator added class by class."""
    e = torch.exp(t - t.amax(dim=-1, keepdim=True))
    denom = e[..., 0]
    for q in range(1, e.shape[-1]):
        denom = denom + e[..., q]
    return e / denom[..., None]


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
    prob = softmax_in_class_order(t_cls)
    conf = iou[..., None] * prob

    n = h * w * a
    return Detections(
        yx_min=yx_min.reshape(b, n, 2),
        yx_max=yx_max.reshape(b, n, 2),
        iou=iou.reshape(b, n),
        prob=prob.reshape(b, n, -1),
        conf=conf.reshape(b, n, -1),
    )
