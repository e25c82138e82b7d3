"""Deterministic eval/detect resize — counterpart of the resize family of
``yolojax/data/transform.py`` (``stretch_batch``, ``letterbox_batch``).

The JAX package resizes with ``jax.image.scale_and_translate(method="linear",
antialias=True)``, which is separable: for each spatial axis it builds an
(input, output) weight matrix from a triangle kernel — widened by 1/scale when
downsampling — normalises each output column, zeroes columns whose sample
falls outside the input, and contracts the image with both matrices.  The
port builds the same matrices and contracts them with plain matmuls;
``F.interpolate`` handles the edges differently.

Both resizes return per-image, per-axis ``(scale, pad)``; detections in
output-normalized coords map back via ``orig_px = (coord*S - pad) / scale``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import parse_attr

__all__ = ["letterbox_batch", "stretch_batch", "letterbox", "stretch", "resize_from_config"]

_F32_EPS = float(np.finfo(np.float32).eps)


def _weight_mat(in_size: int, out_size: int, scale, translation):
    """Per-image linear antialiased resampling weights: scale, translation
    (B,) → (B, in_size, out_size), as ``jax.image``'s ``compute_weight_mat``."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    sample_f = (out_pos + 0.5) * inv_scale - translation[:, None] * inv_scale - 0.5
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    x = torch.abs(sample_f[:, None, :] - in_pos) / kernel_scale[:, :, None]
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def _affine_resize(canvas, hw, out_size: int, scale, pad):
    """canvas (B, C, C, 3) u8, hw/scale/pad (B, 2) → (B, S, S, 3) f32 in [0, 1]."""
    c = canvas.shape[1]
    origin = (c - hw) * 0.5
    translation = pad - origin * scale
    wy = _weight_mat(c, out_size, scale[:, 0], translation[:, 0])   # (B, C, S)
    wx = _weight_mat(c, out_size, scale[:, 1], translation[:, 1])
    img = canvas.to(torch.float32) / 255.0
    rows = torch.einsum("byxc,byi->bixc", img, wy)
    return torch.einsum("bixc,bxj->bijc", rows, wx)


def letterbox_batch(canvas, hw, out_size: int):
    """Aspect-preserving fit with gray bands; (B,C,C,3) u8 → (B,S,S,3) f32;
    hw (B,2) f32 image sizes on the canvas's device."""
    s = float(out_size)
    scale = torch.amin(s / hw, dim=1, keepdim=True).expand(-1, 2)
    pad = (s - hw * scale) * 0.5
    return _affine_resize(canvas, hw, out_size, scale, pad), scale, pad


def stretch_batch(canvas, hw, out_size: int):
    """Per-axis stretch to S×S (darknet eval resize)."""
    scale = float(out_size) / hw
    pad = torch.zeros_like(hw)
    return _affine_resize(canvas, hw, out_size, scale, pad), scale, pad


# ini-visible names for ``[transform] resize``
letterbox = letterbox_batch
stretch = stretch_batch


def resize_from_config(config):
    """Resolve the eval/detect resize fn (``[transform] resize`` dotted path)."""
    return parse_attr(config.get("transform", "resize",
                                 fallback="yolojax.data.transform.stretch"))
