"""Batched greedy NMS over decoded boxes: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/nms.py::nms_select_pallas`` and its postprocess
wrapper ``postprocess_pallas``.  The kernel (``csrc/nms_select.cu``) is CUDA
C++ for ``sm_90a``, built and loaded by ``kernels/_build.py``.  The plain
versions are ``ops.nms.nms_select`` and ``ops.postprocess.postprocess``.

The boxes may broadcast against the scores' leading dims, as in the plain
version.  The kernel reads each score row's boxes through a row index, so
(B, 1, N, 2) boxes against (B, C, N) scores are not copied per class.

:func:`nms_select` runs the plain version only for scores that lie on the
CPU.  For a CUDA tensor it launches the kernel or raises: a failed build,
load or launch is an error, never a fallback.  ``nms_select.launches``
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..ops import nms as plain
from ..ops.decode import Detections
from ..ops.postprocess import PostProcessed, postprocess
from . import _build

__all__ = ["nms_select", "postprocess_nms", "build", "SOURCE"]

SOURCE = _build.CSRC / "nms_select.cu"
# static shared memory a block gets without opting in
_SMEM_LIMIT = 48 * 1024

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = _build.Kernel(SOURCE, "yolo_nms_select", [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32,
                                                    _F32, _F32, _I32])


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def nms_select(yx_min: torch.Tensor, yx_max: torch.Tensor, scores: torch.Tensor,
               threshold: float, overlap: float, max_out: int):
    """Greedy NMS over the last axis → top ``max_out`` picks, score order.

    yx_min / yx_max (..., N, 2), broadcastable against scores (..., N) →
    (idx int32, conf f32, valid bool), each (..., max_out); inputs are
    upcast to f32 (plain version for CPU scores).
    """
    if not scores.is_cuda:
        if scores.device.type == "cpu":
            return plain.nms_select(yx_min, yx_max, scores, threshold, overlap, max_out)
        raise ValueError(f"nms_select: unsupported device {scores.device}")
    lead, n = scores.shape[:-1], scores.shape[-1]
    box_lead = torch.broadcast_shapes(yx_min.shape[:-2], yx_max.shape[:-2])
    if (yx_min.shape[-2:] != (n, 2) or yx_max.shape[-2:] != (n, 2)
            or torch.broadcast_shapes(box_lead, lead) != lead):
        raise ValueError(f"nms_select: boxes {tuple(yx_min.shape)}, {tuple(yx_max.shape)} do "
                         f"not broadcast against scores {tuple(scores.shape)}")
    if not (yx_min.device == yx_max.device == scores.device):
        raise ValueError(f"nms_select: tensors on {yx_min.device}, {yx_max.device}, "
                         f"{scores.device}")
    smem = 6 * n * 4     # corners, scores and the compacted list's indices
    if smem > _SMEM_LIMIT:
        raise ValueError(f"nms_select: {n} candidates need {smem} B of shared memory per "
                         f"block, over {_SMEM_LIMIT}")
    g, dev = math.prod(lead), scores.device
    idx = torch.empty((g, max_out), dtype=torch.int32, device=dev)
    conf = torch.empty((g, max_out), dtype=torch.float32, device=dev)
    count = torch.zeros(g, dtype=torch.int32, device=dev)
    if g and max_out:
        # one (N, 4) row of [ymin, xmin, ymax, xmax] per distinct box row, and
        # the box row each score row reads
        boxes = torch.cat([yx_min.broadcast_to(*box_lead, n, 2),
                           yx_max.broadcast_to(*box_lead, n, 2)], dim=-1).to(torch.float32)
        box_row = (torch.arange(math.prod(box_lead), dtype=torch.int32, device=dev)
                   .reshape(box_lead).broadcast_to(lead).reshape(g).contiguous())
        scores32 = scores.to(torch.float32).reshape(g, n).contiguous()
        _KERNEL(scores, boxes.data_ptr(), scores32.data_ptr(), box_row.data_ptr(),
                idx.data_ptr(), conf.data_ptr(), count.data_ptr(), g, n, threshold, overlap,
                max_out)
        nms_select.launches += 1
    valid = torch.arange(max_out, device=dev) < count[:, None]
    shape = (*lead, max_out)
    return idx.reshape(shape), conf.reshape(shape), valid.reshape(shape)


nms_select.launches = 0


def postprocess_nms(det: Detections, threshold: float, overlap: float,
                    topk: int) -> PostProcessed:
    """Per-class threshold + NMS on decoded detections (B, N, ·) through
    :func:`nms_select`, then the gather of the picked corners."""
    return postprocess(det, threshold, overlap, topk, select=nms_select)
