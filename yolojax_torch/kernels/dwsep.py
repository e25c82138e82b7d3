"""Fused depthwise-separable block: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/dwsep.py::dwsep_pallas``:
leaky(pw1×1(leaky(dw3×3(x) + bd)) + bp) on folded params.  The kernel
(``csrc/dwsep.cu``) is CUDA C++ for ``sm_90a``, built and loaded by
``kernels/_build.py``: in bf16 the pointwise product runs on the tensor
cores (``wgmma``), in f32 on the CUDA cores.  The plain version is the
unfused pair, two ``models.blocks.conv_bias_leaky``.

Layouts are the JAX kernel's: x (B, H, W, C) NHWC, dw taps (3, 3, C), pw
weights (C, Cout).  The bf16 kernel reads the pw weights as (Cout, C), the
folded 1×1 conv's own layout: the engine passes that view as ``wp_t``
(``engine.add_kernel_weights``), so a call converts nothing; without it the
wrapper makes the copy.

:func:`dwsep` runs the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises.  ``dwsep.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.blocks import conv_bias_leaky
from . import _build

__all__ = ["dwsep", "dwsep_plain", "build", "SOURCE", "MAX_BF16_CHANNELS"]

SOURCE = _build.CSRC / "dwsep.cu"
# the bf16 kernel keeps a depthwise block of M pixels x C channels in shared
# memory: C <= 1024 at M = 64 (csrc/dwsep.cu, kMaxABytes)
MAX_BF16_CHANNELS = 1024
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_ARGS = [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _I32]
_BF16 = _build.Kernel(SOURCE, "yolo_dwsep_bf16", _ARGS)
_F32 = _build.Kernel(SOURCE, "yolo_dwsep_f32", _ARGS)


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
    dtype = x.dtype
    if (dtype not in (torch.bfloat16, torch.float32) or wd.dtype != dtype or wp.dtype != dtype
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
    if stride != 1 and stride != 2:
        raise ValueError(f"dwsep: stride {stride}; expected 1 or 2")
    if dtype == torch.bfloat16:
        if c > MAX_BF16_CHANNELS:
            raise ValueError(f"dwsep: {c} channels; the bf16 kernel takes at most "
                             f"{MAX_BF16_CHANNELS}")
    elif x.shape[0] > 65535:
        raise ValueError(f"dwsep: batch {x.shape[0]} over the f32 kernel's grid of 65535")
    if not (x.is_contiguous() and wd.is_contiguous() and bd.is_contiguous()
            and wp.is_contiguous() and bp.is_contiguous()):
        raise ValueError("dwsep: x, wd, bd, wp and bp must be contiguous (x as NHWC)")
    device = x.get_device()
    if not (wd.get_device() == bd.get_device() == wp.get_device() == bp.get_device() == device):
        raise ValueError(f"dwsep: tensors on {[str(t.device) for t in (x, wd, bd, wp, bp)]}")


def dwsep(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, wp: torch.Tensor,
          bp: torch.Tensor, stride: int = 1, wp_t: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C), dw taps wd (3, 3, C), bd (C,) f32, pw weights wp
    (C, Cout), bp (Cout,) f32 → (B, Ho, Wo, Cout) in x's dtype.  Each conv
    sums in f32 and is rounded to x's dtype before its f32 bias and leaky.
    ``wp_t``: the same pw weights as a contiguous (Cout, C) tensor, which
    the bf16 kernel reads; made from ``wp`` when not given."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return dwsep_plain(x, wd, bd, wp, bp, stride)
        raise ValueError(f"dwsep: unsupported device {x.device}")
    _check(x, wd, bd, wp, bp, stride)
    b, h, w, c = x.shape
    cout = wp.shape[1]
    out = x.new_empty((b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout))
    if out.numel() == 0:
        return out
    if x.dtype == torch.bfloat16:
        if wp_t is None:
            wp_t = wp.t().contiguous()
        elif (wp_t.shape != (cout, c) or wp_t.dtype != x.dtype or not wp_t.is_contiguous()
              or wp_t.get_device() != x.get_device()):
            raise ValueError(f"dwsep: wp_t {tuple(wp_t.shape)} {wp_t.dtype}; expected a "
                             f"contiguous ({cout}, {c}) {x.dtype} tensor on {x.device}")
        _BF16(x, x.data_ptr(), wd.data_ptr(), bd.data_ptr(), wp_t.data_ptr(), bp.data_ptr(),
              out.data_ptr(), b, h, w, c, cout, stride)
    else:
        _F32(x, x.data_ptr(), wd.data_ptr(), bd.data_ptr(), wp.data_ptr(), bp.data_ptr(),
             out.data_ptr(), b, h, w, c, cout, stride)
    dwsep.launches += 1
    return out


dwsep.launches = 0
