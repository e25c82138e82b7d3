"""Train augmentation and the deterministic eval/detect resize — counterpart
of ``yolojax/data/transform.py``.

The JAX package resizes with ``jax.image.scale_and_translate(method="linear",
antialias=True)``, which is separable: for each spatial axis it builds an
(input, output) weight matrix from a triangle kernel — widened by 1/scale when
downsampling — normalises each output column, zeroes columns whose sample
falls outside the input, and contracts the image with both matrices.  The
port builds the same matrices and contracts them with plain matmuls;
``F.interpolate`` handles the edges differently.  The train augmentation
takes ``[transform] antialias = 0`` as the JAX package does: the triangle
is then not widened (plain bilinear, darknet's own resize).

:class:`TrainAugment` is darknet's train-time augmentation on a batch of gray
canvases, with the boxes transformed alongside: a border-jitter crop (pads
that reach past the image sample the gray canvas), the resize to the input
size, a horizontal flip and HSV jitter.  The random draws are split from the
arithmetic: :meth:`TrainAugment.draw` takes them from a ``torch.Generator``
and :meth:`TrainAugment.apply` computes with whatever draws it is given (the
parity tests give it the JAX package's).  The pixels run in ``[transform]
dtype`` (bf16 by default), the box geometry in f32.

Both resizes return per-image, per-axis ``(scale, pad)``; detections in
output-normalized coords map back via ``orig_px = (coord*S - pad) / scale``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import parse_attr, parse_attr_list, torch_dtype

__all__ = ["RandomCrop", "RandomFlipHorizontally", "HSVJitter", "TrainAugment", "rgb_to_hsv",
           "hsv_to_rgb", "letterbox_batch", "stretch_batch", "letterbox", "stretch",
           "resize_from_config"]

_F32_EPS = float(np.finfo(np.float32).eps)


def _weight_mat(in_size: int, out_size: int, scale, translation, antialias: bool = True):
    """Per-image linear resampling weights: scale, translation (B,) → (B,
    in_size, out_size), as ``jax.image``'s ``compute_weight_mat``; with
    ``antialias`` the triangle widens by 1/scale when downsampling, without
    it the support stays one input pixel (plain bilinear, darknet's resize)."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None]
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    sample_f = (out_pos + 0.5) * inv_scale - translation[:, None] * inv_scale - 0.5
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :, None]
    x = torch.abs(sample_f[:, None, :] - in_pos)
    if antialias:
        x = x / torch.clamp(inv_scale, min=1.0)[:, :, None]
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=1, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000.0 * _F32_EPS,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[:, None, :], weights, 0.0)


def _resize(img, out_size: int, scale, translation, antialias: bool = True):
    """img (B, C, C, 3) → (B, S, S, 3) in ``img``'s dtype: the weight
    matrices, built in f32, are cast to it, as ``jax.image`` casts them."""
    c = img.shape[1]
    wy = _weight_mat(c, out_size, scale[:, 0], translation[:, 0], antialias).to(img.dtype)
    wx = _weight_mat(c, out_size, scale[:, 1], translation[:, 1], antialias).to(img.dtype)
    rows = torch.einsum("byxc,byi->bixc", img, wy)
    return torch.einsum("bixc,bxj->bijc", rows, wx)


def _affine_resize(canvas, hw, out_size: int, scale, pad):
    """canvas (B, C, C, 3) u8, hw/scale/pad (B, 2) → (B, S, S, 3) f32 in [0, 1]."""
    origin = (canvas.shape[1] - hw) * 0.5
    translation = pad - origin * scale
    return _resize(canvas.to(torch.float32) / 255.0, out_size, scale, translation)


# --------------------------------------------------------------------------
# color space
# --------------------------------------------------------------------------

def rgb_to_hsv(rgb):
    """(…, 3) float [0,1] RGB → HSV."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.amax(rgb, dim=-1)
    mn = torch.amin(rgb, dim=-1)
    d = mx - mn
    one = torch.ones((), dtype=rgb.dtype, device=rgb.device)
    safe_d = torch.where(d > 0, d, one)
    h = torch.where(mx == r, (g - b) / safe_d % 6.0,
                    torch.where(mx == g, (b - r) / safe_d + 2.0, (r - g) / safe_d + 4.0))
    h = torch.where(d > 0, h / 6.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, one), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = i.to(torch.int32) % 6

    def sector(c0, c1, c2, c3, c4, c5):
        return torch.where(i == 0, c0, torch.where(i == 1, c1, torch.where(
            i == 2, c2, torch.where(i == 3, c3, torch.where(i == 4, c4, c5)))))

    r = sector(v, q, p, p, t, v)
    g = sector(t, v, v, q, p, p)
    b = sector(p, p, t, v, v, q)
    return torch.stack([r, g, b], dim=-1)


# --------------------------------------------------------------------------
# transform marker classes — the ini-visible names of ``[transform] train``
# --------------------------------------------------------------------------

@dataclass
class RandomCrop:
    """Darknet border-jitter crop; pads sample the gray canvas."""

    jitter: float = 0.2


@dataclass
class RandomFlipHorizontally:
    prob: float = 0.5


@dataclass
class HSVJitter:
    hue: float = 0.1
    saturation: float = 1.5
    exposure: float = 1.5


def _uniform(generator, shape, lo: float, hi: float):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=torch.float32)


def _rand_scale(generator, batch: int, smax: float):
    """darknet rand_scale per image: s ~ U(1, smax), inverted with p=0.5."""
    s = _uniform(generator, (batch,), 1.0, smax)
    keep = torch.rand((batch,), generator=generator) < 0.5
    return torch.where(keep, s, 1.0 / s)


# --------------------------------------------------------------------------
# train-time augmentation
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainAugment:
    """Config-resolved augmentation parameters (see the module docstring)."""

    crop: bool = True
    flip: bool = True
    hsv: bool = True
    jitter: float = 0.2
    hue: float = 0.1
    saturation: float = 1.5
    exposure: float = 1.5
    flip_prob: float = 0.5
    dtype: torch.dtype = torch.bfloat16   # pixel dtype; box geometry stays f32
    # darknet's own resize has no antialias prefilter; True widens the
    # triangle on a downscale, as the JAX package's default does
    antialias: bool = True

    @classmethod
    def from_config(cls, config):
        names = {t.__name__ if isinstance(t, type) else type(t).__name__
                 for t in parse_attr_list(config.get("transform", "train", fallback=""))}
        return cls(
            crop="RandomCrop" in names,
            flip="RandomFlipHorizontally" in names,
            hsv="HSVJitter" in names,
            jitter=config.getfloat("transform", "jitter", fallback=0.2),
            hue=config.getfloat("transform", "hue", fallback=0.1),
            saturation=config.getfloat("transform", "saturation", fallback=1.5),
            exposure=config.getfloat("transform", "exposure", fallback=1.5),
            dtype=torch_dtype(config.get("transform", "dtype", fallback="bfloat16")),
            antialias=config.getboolean("transform", "antialias", fallback=True),
        )

    def draw(self, generator: torch.Generator, batch: int) -> dict:
        """The random draws of one batch, on the generator's device: ``pads``
        (B, 4) top/bottom/left/right as fractions of the image's (h, h, w, w),
        ``flip`` (B,) bool, hue shift ``dh`` and saturation / exposure scales
        ``ds`` / ``dv`` (B,).  Only the enabled ops draw."""
        out = {}
        if self.crop:
            out["pads"] = _uniform(generator, (batch, 4), -self.jitter, self.jitter)
        if self.flip:
            out["flip"] = torch.rand((batch,), generator=generator) < self.flip_prob
        if self.hsv:
            out["dh"] = _uniform(generator, (batch,), -self.hue, self.hue)
            out["ds"] = _rand_scale(generator, batch, self.saturation)
            out["dv"] = _rand_scale(generator, batch, self.exposure)
        return out

    def apply(self, canvas, hw, yx_min, yx_max, valid, draws: dict, out_size: int):
        """canvas (B, C, C, 3) u8 with the image centered, hw (B, 2), boxes
        (B, G, 2) normalized to the image, valid (B, G) → (images (B, S, S,
        3) in ``self.dtype``, yx_min, yx_max normalized to the crop (f32),
        valid with degenerate boxes dropped)."""
        dev = canvas.device
        f32 = torch.float32
        draws = {k: v.to(dev) for k, v in draws.items()}
        hw = hw.to(f32)
        b, c = canvas.shape[0], canvas.shape[1]
        h, w = hw[:, 0], hw[:, 1]
        origin = (c - hw) * 0.5                                    # centered paste

        # crop box in image-frame pixels (pads may be negative = pad)
        if self.crop:
            pads = draws["pads"].to(f32) * torch.stack([h, h, w, w], dim=1)
            pads = torch.maximum(pads, -origin[:, [0, 0, 1, 1]])  # clamp to the margin
            pt, pb, pl, pr = pads.unbind(1)
        else:
            pt = pb = pl = pr = torch.zeros((b,), dtype=f32, device=dev)
        crop_hw = torch.stack([h - pt - pb, w - pl - pr], dim=1)
        crop_origin = origin + torch.stack([pt, pl], dim=1)       # canvas coords

        # resize the crop to (S, S)
        scale = float(out_size) / crop_hw
        translation = -crop_origin * scale
        pixels = canvas.to(self.dtype) * torch.tensor(1 / 255.0, dtype=self.dtype, device=dev)
        img = _resize(pixels, out_size, scale, translation, self.antialias)

        # boxes: image-normalized → crop-normalized
        off = torch.stack([pt, pl], dim=1)[:, None, :]
        new_min = torch.clamp((yx_min.to(f32) * hw[:, None, :] - off) / crop_hw[:, None, :], 0.0, 1.0)
        new_max = torch.clamp((yx_max.to(f32) * hw[:, None, :] - off) / crop_hw[:, None, :], 0.0, 1.0)
        ext = new_max - new_min
        valid = valid.to(torch.bool) & (ext[..., 0] > 1e-3) & (ext[..., 1] > 1e-3)

        if self.flip:
            do = draws["flip"].to(torch.bool)
            img = torch.where(do[:, None, None, None], img.flip(2), img)
            fmin = torch.stack([new_min[..., 0], 1.0 - new_max[..., 1]], dim=-1)
            fmax = torch.stack([new_max[..., 0], 1.0 - new_min[..., 1]], dim=-1)
            new_min = torch.where(do[:, None, None], fmin, new_min)
            new_max = torch.where(do[:, None, None], fmax, new_max)

        if self.hsv:
            # the jitter scalars in the pixel dtype, as the JAX package casts them
            dh, ds, dv = (draws[k].to(img.dtype)[:, None, None] for k in ("dh", "ds", "dv"))
            hsv = rgb_to_hsv(torch.clamp(img, 0.0, 1.0))
            hsv = torch.stack([(hsv[..., 0] + dh) % 1.0,
                               torch.clamp(hsv[..., 1] * ds, 0.0, 1.0),
                               torch.clamp(hsv[..., 2] * dv, 0.0, 1.0)], dim=-1)
            img = hsv_to_rgb(hsv)
        return img, new_min, new_max, valid


# --------------------------------------------------------------------------
# deterministic eval/detect resize family (``[transform] resize``)
# --------------------------------------------------------------------------

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
