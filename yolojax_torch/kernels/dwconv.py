"""Depthwise 3×3 conv + bias + leaky: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/dwconv.py::dwconv3x3_pallas`` together with the
folded epilogue the JAX engine runs after it (``engine.py::_post_conv``).
The kernel (``csrc/dwconv3x3.cu``) is CUDA C++ for ``sm_90a``, built and
loaded by ``kernels/_build.py``.  The plain version is ``F.conv2d`` with
``groups=C`` followed by ``models.blocks.bias_leaky``.  :func:`dwconv3x3_taps`
is the kernel's own op order in separate torch ops (an f32 sum over the nine
shifted slices of the zero-padded input, dy outer, dx inner, a product then
an add): the kernel's output is bit-identical to it.

Layouts are the JAX kernel's: x (B, H, W, C) NHWC, taps (3, 3, C).  The
engine's running tensor is NCHW in ``channels_last`` memory, so it hands its
own bytes over through a permuted view.

:func:`dwconv3x3` runs the plain version only for a tensor on the CPU.  For a
CUDA tensor it launches the kernel or raises.  ``dwconv3x3.launches`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..models.blocks import bias_leaky, leaky_relu
from . import _build

__all__ = ["dwconv3x3", "dwconv3x3_plain", "dwconv3x3_taps", "build", "SOURCE"]

SOURCE = _build.CSRC / "dwconv3x3.cu"
_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
_KERNEL = _build.Kernel(SOURCE, "yolo_dwconv3x3", [_PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32,
                                                   _I32, _I32, _I32])
_DTYPES = (torch.bfloat16, torch.float32)


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def dwconv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
                    act: bool = True) -> torch.Tensor:
    """The plain version: cuDNN's (or the CPU's) grouped conv, then the f32
    bias + leaky epilogue.  Same arguments as :func:`dwconv3x3`."""
    c = x.shape[-1]
    weight = w.permute(2, 0, 1).unsqueeze(1)          # (3, 3, C) → OIHW (C, 1, 3, 3)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, stride=stride, padding=1, groups=c)
    return bias_leaky(y, b, act).permute(0, 2, 3, 1).contiguous()


def dwconv3x3_taps(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
                   act: bool = True) -> torch.Tensor:
    """The tap-order reference: the kernel's arithmetic in separate torch ops.
    Same arguments as :func:`dwconv3x3`.  ``acc + patch * tap`` is two ops,
    so no multiply and add fuse into one rounding."""
    bsz, h, wd, c = x.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    taps = w.float()
    acc = torch.zeros((bsz, ho, wo, c), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            acc = acc + patch * taps[dy, dx]
    z = acc.to(x.dtype).float() + b
    if act:
        z = leaky_relu(z)
    return z.to(x.dtype)


def _check(x, w, b, stride):
    if x.dtype not in _DTYPES or w.dtype != x.dtype or b.dtype != torch.float32:
        raise TypeError(f"dwconv3x3: x {x.dtype}, w {w.dtype}, b {b.dtype}; expected x and w "
                        "both float32 or both bfloat16, b float32")
    c = x.shape[-1]
    if x.dim() != 4 or w.shape != (3, 3, c) or b.shape != (c,):
        raise ValueError(f"dwconv3x3: x {tuple(x.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}; expected (B, H, W, C), (3, 3, C), (C,)")
    if stride != 1 and stride != 2:
        raise ValueError(f"dwconv3x3: stride {stride}; expected 1 or 2")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("dwconv3x3: x, w and b must be contiguous (x as NHWC)")
    if not (x.get_device() == w.get_device() == b.get_device()):
        raise ValueError(f"dwconv3x3: tensors on {x.device}, {w.device}, {b.device}")


def dwconv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
              act: bool = True) -> torch.Tensor:
    """x (B, H, W, C), taps w (3, 3, C) in x's dtype, bias b (C,) f32 →
    (B, Ho, Wo, C) in x's dtype: depthwise 3×3 SAME conv (symmetric padding
    1, f32 sum), rounded, then ``+ b`` and leaky (``act``) in f32, rounded."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return dwconv3x3_plain(x, w, b, stride, act)
        raise ValueError(f"dwconv3x3: unsupported device {x.device}")
    _check(x, w, b, stride)
    bsz, h, wd, c = x.shape
    y = x.new_empty((bsz, (h - 1) // stride + 1, (wd - 1) // stride + 1, c))
    if y.numel() == 0:
        return y
    _KERNEL(x, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), bsz, h, wd, c, stride,
            act, x.dtype == torch.bfloat16)
    dwconv3x3.launches += 1
    return y


dwconv3x3.launches = 0
