"""The bias + leaky epilogue of a folded conv over NHWC in one pass: the
Hopper kernel and its plain version.

Replaces ``models/blocks.py::bias_leaky`` where the engine runs a conv's
epilogue on its own, i.e. where no pool, reorg or depthwise kernel takes it
(the JAX engine's ``_post_conv``, which XLA fuses into the conv).  The
kernel (``csrc/bias_leaky.cu``, the epilogue in ``csrc/epilogue.cuh``) is
CUDA C++ for ``sm_90a``, built and loaded by ``kernels/_build.py``.  It
runs after the conv, on cuDNN's output already rounded to the compute
dtype, so the bias is added where the plain version adds it (a library's
fused conv + bias would add it before that rounding).  The plain version is
``bias_leaky`` on the NCHW view.

The layout is NHWC, x (B, H, W, C).  The engine's running tensor is NCHW in
``channels_last`` memory, so it hands its own bytes over through a permuted
view.  x may also be the first C channels of such a tensor whose pixels are
wider, a multiple of 8 values (:func:`pixel_stride`): the raw output of a
conv the engine runs at a padded width (``engine.padded_width``).  The
result is a new contiguous (B, H, W, C) tensor either way.

:func:`bias_leaky_nhwc` runs the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises.
``bias_leaky_nhwc.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.blocks import bias_leaky
from . import _build

__all__ = ["bias_leaky_nhwc", "bias_leaky_nhwc_plain", "pixel_stride", "build", "SOURCE"]

SOURCE = _build.CSRC / "bias_leaky.cu"
_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_KERNEL = _build.Kernel(SOURCE, "yolo_bias_leaky", [_PTR, _PTR, _PTR, _I64, _I32, _I64, _I32,
                                                    _I32])
_DTYPES = (torch.bfloat16, torch.float32)
# a padded x's pixel stride is a multiple of this many values
PIXEL_ALIGN = 8


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def bias_leaky_nhwc_plain(x: torch.Tensor, bias: torch.Tensor, act: bool = True):
    """The plain version: ``bias_leaky`` on the NCHW view of an NHWC
    ``x``, returned as a contiguous NHWC tensor."""
    return bias_leaky(x.permute(0, 3, 1, 2), bias, act).permute(0, 2, 3, 1).contiguous()


def pixel_stride(x: torch.Tensor) -> int | None:
    """The values from one pixel of a (B, H, W, C) ``x`` to the next, as the
    kernel reads them: C where x is contiguous; P where x is the first C
    channels of a contiguous (B, H, W, P) tensor, P a multiple of
    ``PIXEL_ALIGN``; None for any other layout."""
    b, h, w, c = x.shape
    if x.is_contiguous():
        return c
    s0, s1, s2, s3 = x.stride()
    p = s2 if w > 1 else s1 if h > 1 else s0
    dense = s3 == 1 and (h == 1 or s1 == w * p) and (b == 1 or s0 == h * w * p)
    return p if dense and p % PIXEL_ALIGN == 0 and p >= c else None


def _check(x, bias):
    if x.dtype not in _DTYPES:
        raise TypeError(f"bias_leaky_nhwc: x {x.dtype}; expected float32 or bfloat16")
    if x.dim() != 4:
        raise ValueError(f"bias_leaky_nhwc: x {tuple(x.shape)}; expected (B, H, W, C)")
    if pixel_stride(x) is None:
        raise ValueError("bias_leaky_nhwc: x must be contiguous as NHWC, or the first C "
                         f"channels of such a tensor with pixels a multiple of {PIXEL_ALIGN} "
                         f"values apart; got strides {x.stride()}")
    if x.shape[0] * x.shape[1] * x.shape[2] >= 2**31:
        raise ValueError(f"bias_leaky_nhwc: {tuple(x.shape[:3])} is 2^31 pixels or more; the "
                         "grid counts pixel blocks in 32 bits")
    if (bias.dtype != torch.float32 or bias.shape != (x.shape[3],) or not bias.is_contiguous()
            or bias.get_device() != x.get_device()):
        raise ValueError(f"bias_leaky_nhwc: bias {tuple(bias.shape)} {bias.dtype} on "
                         f"{bias.device}; expected a contiguous ({x.shape[3]},) float32 tensor "
                         f"on {x.device}")


def bias_leaky_nhwc(x: torch.Tensor, bias: torch.Tensor, act: bool = True):
    """x (B, H, W, C) raw conv output, contiguous or padded
    (:func:`pixel_stride`) → a new contiguous (B, H, W, C) tensor in x's
    dtype: ``blocks.bias_leaky``'s steps per element (f32 ``+ bias``, leaky
    when ``act``, rounded to x's dtype); ``bias`` (C,) f32."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return bias_leaky_nhwc_plain(x, bias, act)
        raise ValueError(f"bias_leaky_nhwc: unsupported device {x.device}")
    _check(x, bias)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    if y.numel():
        b, h, w, c = x.shape
        _KERNEL(x, x.data_ptr(), bias.data_ptr(), y.data_ptr(), b * h * w, c, pixel_stride(x),
                act, x.dtype == torch.bfloat16)
        bias_leaky_nhwc.launches += 1
    return y


bias_leaky_nhwc.launches = 0
