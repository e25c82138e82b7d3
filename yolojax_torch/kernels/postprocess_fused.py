"""Fused decode + per-class greedy NMS: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/nms.py::postprocess_fused_pallas``.  The kernel
(``csrc/postprocess_fused.cu``) is CUDA C++ for ``sm_90a``, built and loaded
by ``kernels/_build.py``.  The plain version is
``ops.postprocess.postprocess_raw`` (decode → batched greedy NMS).

One call is one device kernel: it reads the head in its own dtype (f32 or
bf16), and writes ``yx_min``, ``yx_max``, ``conf`` and ``keep`` into views of
one allocation.  The kernel decodes each candidate once per group of classes;
:func:`layout` sizes the group by shared memory and by the batch.

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

__all__ = ["postprocess_fused", "layout", "build", "SOURCE"]

SOURCE = _build.CSRC / "postprocess_fused.cu"
# shared memory a block may opt in to on an H100 less the kernel's static
# part, and the part a class group may take so that three blocks fit on an SM
_SMEM_LIMIT = 227 * 1024 - 256
_GROUP_BUDGET = 72 * 1024
_STAGE_ROWS = 256            # head rows staged per step: one per thread
_DTYPES = (torch.float32, torch.bfloat16)

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = _build.Kernel(SOURCE, "yolo_postprocess_fused", [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                                                           _I32, _I32, _I32, _I32, _I32, _I32,
                                                           _I32, _F32, _F32, _I32, _I32])


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def layout(n: int, c: int, b: int, sms: int) -> tuple[int, int]:
    """(classes per block, shared memory bytes per block) for N candidates,
    C classes and a batch of ``b`` on ``sms`` SMs: corners 4·N floats, the
    group's scores group·N floats, and one region for the staged head rows
    (256·(5+C) floats), then the group's compacted indices (group·N ints).
    The group is as large as ``_GROUP_BUDGET`` allows, but no larger than
    leaves about two blocks an SM (each greedy loop is one warp's serial
    chain, so a small batch wants its rows spread); then it is evened out
    over the groups."""
    def smem(g):
        return 4 * (4 * n + g * n + max(g * n, _STAGE_ROWS * (5 + c)))

    g = max(1, min(c, (_GROUP_BUDGET - 16 * n) // (8 * n), -(-b * c // (2 * sms))))
    groups = -(-c // g)
    g = -(-c // groups)
    while g > 1 and smem(g) > _SMEM_LIMIT:
        g -= 1
    if smem(g) > _SMEM_LIMIT:
        raise ValueError(f"postprocess_fused: {n} candidates and {c} classes need {smem(g)} B "
                         f"of shared memory per block, over {_SMEM_LIMIT}")
    return g, smem(g)


# (classes per block, shared memory) per (N, C, batch, device): the wrapper's
# host time is most of a batch-8 call
_LAYOUTS: dict = {}


def postprocess_fused(raw: torch.Tensor, anchors, threshold: float, overlap: float,
                      topk: int) -> PostProcessed:
    """raw (B, H, W, A*(5+C)) + anchors (A, 2) → PostProcessed, decode and
    per-class greedy NMS in one kernel (plain version for a CPU tensor)."""
    if not raw.is_cuda:
        if raw.device.type == "cpu":
            return postprocess_raw(raw, anchors, threshold, overlap, topk)
        raise ValueError(f"postprocess_fused: unsupported device {raw.device}")
    if raw.dtype not in _DTYPES:
        raise TypeError(f"postprocess_fused: raw {raw.dtype}; expected float32 or bfloat16")
    b, h, w, ch = raw.shape
    if not (isinstance(anchors, torch.Tensor) and anchors.dtype == torch.float32
            and anchors.device == raw.device and anchors.is_contiguous()):
        anchors = torch.as_tensor(anchors, dtype=torch.float32, device=raw.device).contiguous()
    a = anchors.shape[0]
    if anchors.shape != (a, 2) or ch % a or ch // a < 6:
        raise ValueError(f"postprocess_fused: head {tuple(raw.shape)} does not match "
                         f"anchors {tuple(anchors.shape)}")
    if b > 65535:
        raise ValueError(f"postprocess_fused: batch {b} over the grid's 65535")
    c, n = ch // a - 5, h * w * a
    key = (n, c, b, raw.get_device())
    if key not in _LAYOUTS:
        _LAYOUTS[key] = layout(n, c, b, torch.cuda.get_device_properties(key[3])
                               .multi_processor_count)
    group, smem = _LAYOUTS[key]
    raw = raw.contiguous()
    # one allocation: yx_min, yx_max and conf (5 floats a slot), then keep
    k = b * c * topk
    buf = torch.empty(5 * k + (k + 3) // 4, dtype=torch.float32, device=raw.device)
    pair, one = (c * topk * 2, topk * 2, 2, 1), (c * topk, topk, 1)
    out = PostProcessed(buf.as_strided((b, c, topk, 2), pair),
                        buf.as_strided((b, c, topk, 2), pair, 2 * k),
                        buf.as_strided((b, c, topk), one, 4 * k),
                        buf.view(torch.bool).as_strided((b, c, topk), one, 20 * k))
    if k:
        _KERNEL(raw, raw.data_ptr(), anchors.data_ptr(), *(t.data_ptr() for t in out), b, h, w,
                a, c, group, smem, threshold, overlap, topk, raw.dtype == torch.bfloat16)
        postprocess_fused.launches += 1
    return out


postprocess_fused.launches = 0
