"""Space-to-depth reorg (s2d order) over NHWC: the Hopper kernel and its
plain version.

Replaces ``yolojax/kernels/reorg.py::reorg_pallas``.  The kernel
(``csrc/reorg_s2d.cu``) is CUDA C++ for ``sm_90a``, built and loaded by
``kernels/_build.py``.  The plain version is ``ops.reorg.reorg_s2d``.  The
darknet order has no kernel, in the JAX package as here.

:func:`reorg_s2d` runs the plain version only for a tensor on the CPU.  For
a CUDA tensor it launches the kernel or raises.  ``reorg_s2d.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops import reorg as plain
from . import _build

__all__ = ["reorg_s2d", "build", "SOURCE"]

SOURCE = _build.CSRC / "reorg_s2d.cu"
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel(SOURCE, "yolo_reorg_s2d", [_PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _I32])
_DTYPES = (torch.bfloat16, torch.float32)


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def _check(x, stride):
    if x.dtype not in _DTYPES:
        raise TypeError(f"reorg_s2d: x {x.dtype}; expected float32 or bfloat16")
    if x.dim() != 4 or stride < 1:
        raise ValueError(f"reorg_s2d: x {tuple(x.shape)}, stride {stride}; expected "
                         "(B, H, W, C) and stride >= 1")
    if x.shape[1] % stride or x.shape[2] % stride:
        raise ValueError(f"reorg: spatial dims ({x.shape[1]}, {x.shape[2]}) not divisible by "
                         f"stride {stride}")
    if not x.is_contiguous():
        raise ValueError("reorg_s2d: x must be contiguous as NHWC")


def reorg_s2d(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """(B, H, W, C) → (B, H/s, W/s, s*s*C), channel ``(p*s + q)*C + c``."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return plain.reorg_s2d(x, stride)
        raise ValueError(f"reorg_s2d: unsupported device {x.device}")
    _check(x, stride)
    b, h, w, c = x.shape
    s = stride
    y = x.new_empty((b, h // s, w // s, s * s * c))
    if y.numel() == 0:
        return y
    _KERNEL(x, x.data_ptr(), y.data_ptr(), b, h, w, c, s, x.element_size())
    reorg_s2d.launches += 1
    return y


reorg_s2d.launches = 0
