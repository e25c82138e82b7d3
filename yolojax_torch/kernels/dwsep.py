"""Fused depthwise-separable block: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/dwsep.py::dwsep_pallas``:
leaky(pw1×1(leaky(dw3×3(x) + bd)) + bp) on folded params.  The kernel
(``csrc/dwsep.cu``) is CUDA C++ for ``sm_90a``, built and loaded by
``kernels/_build.py``; it computes the pointwise product in its own body.
The plain version is the unfused pair, two ``models.blocks.conv_bias_leaky``.

Layouts are the JAX kernel's: x (B, H, W, C) NHWC, dw taps (3, 3, C), pw
weights (C, Cout).  The folded model stores both (``engine.add_kernel_weights``)
once, so a call converts nothing.

:func:`dwsep` runs the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises.  ``dwsep.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.blocks import conv_bias_leaky
from . import _build

__all__ = ["dwsep", "dwsep_plain", "build", "SOURCE"]

SOURCE = _build.CSRC / "dwsep.cu"
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"yolo_dwsep": [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32,
                              _I32, _I32, _PTR]}
_DTYPES = (torch.float32, torch.bfloat16)


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def dwsep_plain(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, wp: torch.Tensor,
                bp: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The plain version: the depthwise block, then the pointwise block, each
    a conv in the compute dtype with the f32 bias + leaky epilogue.  Same
    arguments as :func:`dwsep`."""
    c = x.shape[-1]
    y = conv_bias_leaky(x.permute(0, 3, 1, 2), wd.permute(2, 0, 1).unsqueeze(1), bd,
                        stride=stride, groups=c)
    z = conv_bias_leaky(y, wp.t()[:, :, None, None], bp)
    return z.permute(0, 2, 3, 1).contiguous()


def _check(x, wd, bd, wp, bp, stride):
    if (x.dtype not in _DTYPES or wd.dtype != x.dtype or wp.dtype != x.dtype
            or bd.dtype != torch.float32 or bp.dtype != torch.float32):
        raise TypeError(f"dwsep: x {x.dtype}, wd {wd.dtype}, wp {wp.dtype}, bd {bd.dtype}, "
                        f"bp {bp.dtype}; expected x, wd, wp all float32 or all bfloat16 and "
                        "float32 biases")
    c = x.shape[-1]
    cout = wp.shape[-1] if wp.dim() == 2 else -1
    if (x.dim() != 4 or wd.shape != (3, 3, c) or bd.shape != (c,) or wp.shape != (c, cout)
            or bp.shape != (cout,)):
        raise ValueError(f"dwsep: x {tuple(x.shape)}, wd {tuple(wd.shape)}, bd "
                         f"{tuple(bd.shape)}, wp {tuple(wp.shape)}, bp {tuple(bp.shape)}; "
                         "expected (B, H, W, C), (3, 3, C), (C,), (C, Cout), (Cout,)")
    if stride not in (1, 2):
        raise ValueError(f"dwsep: stride {stride}; expected 1 or 2")
    if x.shape[0] > 65535:
        raise ValueError(f"dwsep: batch {x.shape[0]} over the grid's 65535")
    tensors = (x, wd, bd, wp, bp)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dwsep: x, wd, bd, wp and bp must be contiguous (x as NHWC)")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"dwsep: tensors on {[str(t.device) for t in tensors]}")


def dwsep(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, wp: torch.Tensor,
          bp: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, H, W, C), dw taps wd (3, 3, C), bd (C,) f32, pw weights wp
    (C, Cout), bp (Cout,) f32 → (B, Ho, Wo, Cout) in x's dtype.  Each conv
    sums in f32 and is rounded to x's dtype before its f32 bias and leaky."""
    if x.device.type == "cpu":
        return dwsep_plain(x, wd, bd, wp, bp, stride)
    if x.device.type != "cuda":
        raise ValueError(f"dwsep: unsupported device {x.device}")
    _check(x, wd, bd, wp, bp, stride)
    b, h, w, c = x.shape
    cout = wp.shape[1]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load(SOURCE, _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.yolo_dwsep(x.data_ptr(), wd.data_ptr(), bd.data_ptr(), wp.data_ptr(),
                             bp.data_ptr(), out.data_ptr(), b, h, w, c, cout, stride,
                             int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "dwsep")
    dwsep.launches += 1
    return out


dwsep.launches = 0
