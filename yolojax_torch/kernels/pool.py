"""2×2 stride-2 max pool over NHWC, optionally with the bias + leaky epilogue
of the conv before it: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/pool.py::maxpool2x2_pallas`` and, in the fused
mode, the epilogue the engine runs between a conv and its pool
(``models/blocks.py::bias_leaky``).  The kernel (``csrc/maxpool2x2.cu``, the
epilogue in ``csrc/epilogue.cuh``) is CUDA C++ for ``sm_90a``, built and
loaded by ``kernels/_build.py``.  The plain version is ``bias_leaky`` (when
fused) then ``F.max_pool2d`` on the NCHW view, which is what the engine runs
for a conv and a pool that no kernel takes.

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

from ..models.blocks import bias_leaky
from . import _build

__all__ = ["maxpool2x2", "maxpool2x2_plain", "build", "SOURCE"]

SOURCE = _build.CSRC / "maxpool2x2.cu"
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel(SOURCE, "yolo_maxpool2x2", [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                                                    _I32, _I32])
_DTYPES = (torch.bfloat16, torch.float32)
# the grid's y: blocks of 256 threads over an output row's 16-byte units
_MAX_ROW_UNITS = 65535 * 256


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def _epilogue(x, bias, act):
    """``bias_leaky`` on an NHWC tensor (it takes NCHW), returned NHWC."""
    return bias_leaky(x.permute(0, 3, 1, 2), bias, act).permute(0, 2, 3, 1).contiguous()


def maxpool2x2_plain(x: torch.Tensor, bias: torch.Tensor | None = None, act: bool = True,
                     full: bool = False):
    """The plain version: ``bias_leaky`` when ``bias`` is given, then
    ``F.max_pool2d`` on the NCHW view; contiguous NHWC tensors.  Same
    arguments and results as :func:`maxpool2x2`."""
    if bias is not None:
        x = _epilogue(x, bias, act)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1).contiguous()
    return (y, x) if full else y


def _check(x, bias=None):
    if x.dtype not in _DTYPES:
        raise TypeError(f"maxpool2x2: x {x.dtype}; expected float32 or bfloat16")
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"maxpool2x2: x {tuple(x.shape)}; expected (B, H, W, C) with H and W "
                         "even")
    if not x.is_contiguous():
        raise ValueError("maxpool2x2: x must be contiguous as NHWC")
    if x.shape[2] * x.shape[3] >= 2**31 or x.shape[2] // 2 * x.shape[3] > _MAX_ROW_UNITS:
        raise ValueError(f"maxpool2x2: rows of {x.shape[2]} x {x.shape[3]} elements; the "
                         "kernel indexes a row in 32 bits")
    if bias is None:
        return
    if (bias.dtype != torch.float32 or bias.shape != (x.shape[3],) or not bias.is_contiguous()
            or bias.get_device() != x.get_device()):
        raise ValueError(f"maxpool2x2: bias {tuple(bias.shape)} {bias.dtype} on {bias.device}; "
                         f"expected a contiguous ({x.shape[3]},) float32 tensor on {x.device}")


def maxpool2x2(x: torch.Tensor, bias: torch.Tensor | None = None, act: bool = True,
               full: bool = False):
    """x (B, H, W, C), H and W even → (B, H/2, W/2, C) in x's dtype, the max
    of each 2×2 window.

    With ``bias`` (C,) f32, ``x`` is a raw conv output and each element first
    goes through ``blocks.bias_leaky``'s steps (f32 ``+ bias``, leaky when
    ``act``, rounded to x's dtype).  ``full=True`` (with a bias) returns
    ``(pooled, epilogue output)``, the second (B, H, W, C)."""
    if full and bias is None:
        raise ValueError("maxpool2x2: full=True needs a bias (the epilogue output)")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return maxpool2x2_plain(x, bias, act, full)
        raise ValueError(f"maxpool2x2: unsupported device {x.device}")
    _check(x, bias)
    b, h, w, c = x.shape
    y = x.new_empty((b, h // 2, w // 2, c))
    out = x.new_empty((b, h, w, c)) if full else None
    if y.numel():
        _KERNEL(x, x.data_ptr(), None if bias is None else bias.data_ptr(), y.data_ptr(),
                None if out is None else out.data_ptr(), b, h, w, c, act, x.dtype == torch.bfloat16)
        maxpool2x2.launches += 1
    return (y, out) if full else y


maxpool2x2.launches = 0
