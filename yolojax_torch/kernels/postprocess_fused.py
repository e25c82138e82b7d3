"""Fused decode + per-class greedy NMS: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/nms.py::postprocess_fused_pallas``.  The kernel
(``csrc/postprocess_fused.cu``) is CUDA C++ for ``sm_90a``, built and loaded
by ``kernels/_build.py``.  The plain version is
``ops.postprocess.postprocess_raw`` (decode → batched greedy NMS).

:func:`postprocess_fused` runs the plain version only for a raw head that
lies on the CPU.  For a CUDA tensor it launches the kernel or raises: a
failed build, load or launch is an error, never a fallback.
``postprocess_fused.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.postprocess import PostProcessed, postprocess_raw
from . import _build

__all__ = ["postprocess_fused", "build", "SOURCE"]

SOURCE = _build.CSRC / "postprocess_fused.cu"
# static shared memory a block gets without opting in
_SMEM_LIMIT = 48 * 1024

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = _build.Kernel(SOURCE, "yolo_postprocess_fused", [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                                           _I32, _I32, _I32, _I32, _I32, _F32,
                                                           _F32, _I32])


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def postprocess_fused(raw: torch.Tensor, anchors, threshold: float, overlap: float,
                      topk: int) -> PostProcessed:
    """raw (B, H, W, A*(5+C)) + anchors (A, 2) → PostProcessed, decode and
    per-class greedy NMS in one kernel (plain version for a CPU tensor)."""
    if not raw.is_cuda:
        if raw.device.type == "cpu":
            return postprocess_raw(raw, anchors, threshold, overlap, topk)
        raise ValueError(f"postprocess_fused: unsupported device {raw.device}")
    b, h, w, ch = raw.shape
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=raw.device).contiguous()
    a = anchors.shape[0]
    if anchors.shape != (a, 2) or ch % a or ch // a < 6:
        raise ValueError(f"postprocess_fused: head {tuple(raw.shape)} does not match "
                         f"anchors {tuple(anchors.shape)}")
    c, n = ch // a - 5, h * w * a
    smem = (5 * n + 2 * topk) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"postprocess_fused: {n} candidates and topk {topk} need {smem} B "
                         f"of shared memory per block, over {_SMEM_LIMIT}")
    if b > 65535:
        raise ValueError(f"postprocess_fused: batch {b} over the grid's 65535")
    raw32 = raw.to(torch.float32).contiguous()
    dev = raw.device
    yx_min = torch.empty((b, c, topk, 2), dtype=torch.float32, device=dev)
    yx_max = torch.empty((b, c, topk, 2), dtype=torch.float32, device=dev)
    conf = torch.empty((b, c, topk), dtype=torch.float32, device=dev)
    count = torch.empty((b, c), dtype=torch.int32, device=dev)
    _KERNEL(raw, raw32.data_ptr(), anchors.data_ptr(), yx_min.data_ptr(), yx_max.data_ptr(),
            conf.data_ptr(), count.data_ptr(), b, h, w, a, c, threshold, overlap, topk)
    postprocess_fused.launches += 1
    keep = torch.arange(topk, device=dev) < count[..., None]
    return PostProcessed(yx_min, yx_max, conf, keep)


postprocess_fused.launches = 0
