"""2×2 stride-2 max pool over NHWC: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/pool.py::maxpool2x2_pallas``.  The kernel
(``csrc/maxpool2x2.cu``) is CUDA C++ for ``sm_90a``, built and loaded by
``kernels/_build.py``.  The plain version is ``F.max_pool2d`` on the NCHW
view, which is what the engine runs for a pool that no kernel takes.

The layout is the JAX kernel's, x (B, H, W, C) NHWC.  The engine's running
tensor is NCHW in ``channels_last`` memory, so it hands its own bytes over
through a permuted view.

:func:`maxpool2x2` runs the plain version only for a tensor on the CPU.  For
a CUDA tensor it launches the kernel or raises.  ``maxpool2x2.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["maxpool2x2", "maxpool2x2_plain", "build", "SOURCE"]

SOURCE = _build.CSRC / "maxpool2x2.cu"
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel(SOURCE, "yolo_maxpool2x2", [_PTR, _PTR, _I32, _I32, _I32, _I32, _I32])
_DTYPES = (torch.bfloat16, torch.float32)


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def maxpool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.max_pool2d`` on the NCHW view, returned as a
    contiguous NHWC tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).contiguous()


def _check(x):
    if x.dtype not in _DTYPES:
        raise TypeError(f"maxpool2x2: x {x.dtype}; expected float32 or bfloat16")
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"maxpool2x2: x {tuple(x.shape)}; expected (B, H, W, C) with H and W "
                         "even")
    if not x.is_contiguous():
        raise ValueError("maxpool2x2: x must be contiguous as NHWC")


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), H and W even → (B, H/2, W/2, C) in x's dtype, the max
    of each 2×2 window."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return maxpool2x2_plain(x)
        raise ValueError(f"maxpool2x2: unsupported device {x.device}")
    _check(x)
    b, h, w, c = x.shape
    y = x.new_empty((b, h // 2, w // 2, c))
    if y.numel() == 0:
        return y
    _KERNEL(x, x.data_ptr(), y.data_ptr(), b, h, w, c, x.dtype == torch.bfloat16)
    maxpool2x2.launches += 1
    return y


maxpool2x2.launches = 0
