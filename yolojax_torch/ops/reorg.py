"""Reorg / passthrough layer — counterpart of ``yolojax/ops/reorg.py``.

Both channel orders, on NHWC tensors as in the JAX package, as view/permute
chains (exact):

* ``reorg_s2d`` — clean offset-major space-to-depth,
  ``out[..., (p*s + q)*C + c] = in[hi*s + p, wi*s + q, c]``;
* ``reorg_darknet`` — darknet's ``reorg_cpu``: reinterpret the CHW buffer as
  (C/s², H·s, W·s), space-to-depth that view, reinterpret the result as
  (C·s², H/s, W/s).  Not s2d, not even up to a channel permutation.

The darknet order reinterprets a CHW buffer, so the input is copied into
the standard NCHW format first; a ``channels_last`` tensor would otherwise
refuse the ``view``.  The copy is an explicit ``clone``, not
``contiguous()``: ``torch.export`` decides at trace time whether
``contiguous()`` copies, from the strides its fake tensors report, and
those (NCHW for a cuDNN convolution's output, which is ``channels_last`` on
the card) would leave a replayed program a ``view`` that the real tensor
refuses.  On the card the input is ``channels_last``, so ``contiguous()``
copied there as well.
"""

from __future__ import annotations

import torch

__all__ = ["reorg", "reorg_s2d", "reorg_darknet"]


def _check(h: int, w: int, s: int) -> None:
    if h % s or w % s:
        raise ValueError(f"reorg: spatial dims ({h}, {w}) not divisible by stride {s}")


def reorg_s2d(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """(B, H, W, C) → (B, H/s, W/s, s*s*C), channel ``(p*s + q)*C + c``."""
    b, h, w, c = x.shape
    s = stride
    _check(h, w, s)
    t = x.contiguous().view(b, h // s, s, w // s, s, c)
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, h // s, w // s, s * s * c)


def reorg_darknet(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Darknet's true ``reorg_cpu`` semantics on an NHWC tensor."""
    b, h, w, c = x.shape
    s = stride
    _check(h, w, s)
    if c % (s * s):
        raise ValueError(f"darknet reorg: channels {c} not divisible by stride² {s*s}")
    oc = c // (s * s)
    t = x.permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)
    t = t.view(b, oc, h, s, w, s)                       # (b, c2, j, p, i, q)
    t = t.permute(0, 3, 5, 1, 2, 4).contiguous()        # (b, p, q, c2, j, i)
    return t.view(b, c * s * s, h // s, w // s).permute(0, 2, 3, 1)


def reorg(x: torch.Tensor, stride: int = 2, order: str = "darknet") -> torch.Tensor:
    """Dispatch on the configured channel-order variant."""
    if order == "darknet":
        return reorg_darknet(x, stride)
    if order == "s2d":
        return reorg_s2d(x, stride)
    raise ValueError(f"unknown reorg order {order!r} (expected darknet|s2d)")
