"""Space-to-depth reorg (s2d order) over NHWC, optionally with the bias +
leaky epilogue of the conv before it and the passthrough's concat after it:
the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/reorg.py::reorg_pallas`` and, when fused, the
engine's epilogue before it (``models/blocks.py::bias_leaky``) and its
``concat`` after it.  The kernel (``csrc/reorg_s2d.cu``, the epilogue in
``csrc/epilogue.cuh``) is CUDA C++ for ``sm_90a``, built and loaded by
``kernels/_build.py``.  The plain version is ``ops.reorg.reorg_s2d`` (after
``bias_leaky``, and followed by ``torch.cat`` with the tail).  The darknet
order has no kernel, in the JAX package as here.

:func:`reorg_s2d` runs the plain version only for a tensor on the CPU.  For
a CUDA tensor it launches the kernel or raises.  ``reorg_s2d.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import reorg as plain
from . import _build
from .epilogue import bias_leaky_nhwc_plain

__all__ = ["reorg_s2d", "reorg_s2d_plain", "build", "SOURCE"]

SOURCE = _build.CSRC / "reorg_s2d.cu"
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel(SOURCE, "yolo_reorg_s2d", [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                                                   _I32, _I32, _I32, _I32])
_DTYPES = (torch.bfloat16, torch.float32)
# the grid's y: blocks of 256 threads over an output row's units
_MAX_ROW_UNITS = 65535 * 256


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def reorg_s2d_plain(x: torch.Tensor, stride: int = 2, tail: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None, act: bool = True) -> torch.Tensor:
    """The plain version: ``bias_leaky`` when ``bias`` is given, the s2d
    view chain, then ``torch.cat`` with ``tail``.  Same arguments as
    :func:`reorg_s2d`."""
    if bias is not None:
        x = bias_leaky_nhwc_plain(x, bias, act)
    y = plain.reorg_s2d(x, stride)
    return y if tail is None else torch.cat([y, tail], dim=-1)


def _check(x, stride, tail=None, bias=None):
    if x.dtype not in _DTYPES:
        raise TypeError(f"reorg_s2d: x {x.dtype}; expected float32 or bfloat16")
    if x.dim() != 4 or stride < 1:
        raise ValueError(f"reorg_s2d: x {tuple(x.shape)}, stride {stride}; expected "
                         "(B, H, W, C) and stride >= 1")
    b, h, w, c = x.shape
    if h % stride or w % stride:
        raise ValueError(f"reorg: spatial dims ({h}, {w}) not divisible by stride {stride}")
    if not x.is_contiguous():
        raise ValueError("reorg_s2d: x must be contiguous as NHWC")
    ct = 0
    if tail is not None:
        ct = tail.shape[-1]
        if (tail.dtype != x.dtype or tail.shape != (b, h // stride, w // stride, ct)
                or not tail.is_contiguous() or tail.get_device() != x.get_device()):
            raise ValueError(f"reorg_s2d: tail {tuple(tail.shape)} {tail.dtype}; expected a "
                             f"contiguous (B, H/s, W/s, Ct) {x.dtype} tensor on {x.device}")
    if w * c >= 2**31 or w // stride * (stride * stride * c + ct) > _MAX_ROW_UNITS:
        raise ValueError(f"reorg_s2d: rows of {w} x {c} elements; the kernel indexes a row in "
                         "32 bits")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (c,)
                             or not bias.is_contiguous() or bias.get_device() != x.get_device()):
        raise ValueError(f"reorg_s2d: bias {tuple(bias.shape)} {bias.dtype} on {bias.device}; "
                         f"expected a contiguous ({c},) float32 tensor on {x.device}")


def reorg_s2d(x: torch.Tensor, stride: int = 2, tail: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, act: bool = True) -> torch.Tensor:
    """(B, H, W, C) → (B, H/s, W/s, s*s*C), channel ``(p*s + q)*C + c``.

    With ``bias`` (C,) f32, ``x`` is a raw conv output that first goes
    through ``blocks.bias_leaky``'s steps (leaky when ``act``).  With
    ``tail`` (B, H/s, W/s, Ct) the result is the concat ``[reorg, tail]``,
    (B, H/s, W/s, s*s*C + Ct)."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return reorg_s2d_plain(x, stride, tail, bias, act)
        raise ValueError(f"reorg_s2d: unsupported device {x.device}")
    _check(x, stride, tail, bias)
    b, h, w, c = x.shape
    s = stride
    ct = 0 if tail is None else tail.shape[-1]
    y = x.new_empty((b, h // s, w // s, s * s * c + ct))
    if y.numel():
        _KERNEL(x, x.data_ptr(), None if bias is None else bias.data_ptr(),
                None if tail is None else tail.data_ptr(), y.data_ptr(), b, h, w, c, ct, s, act,
                x.dtype == torch.bfloat16)
        reorg_s2d.launches += 1
    return y


reorg_s2d.launches = 0
