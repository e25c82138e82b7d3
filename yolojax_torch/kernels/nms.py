"""Batched greedy NMS over decoded boxes: the Hopper kernel and its plain version.

Replaces ``yolojax/kernels/nms.py::nms_select_pallas`` and its postprocess
wrapper ``postprocess_pallas``.  The kernel (``csrc/nms_select.cu``) is CUDA
C++ for ``sm_90a``, built and loaded by ``kernels/_build.py``.  The plain
versions are ``ops.nms.nms_select`` and ``ops.postprocess.postprocess``.

The boxes may broadcast against the scores' leading dims, as in the plain
version.  The kernel reads each score row's boxes through a row index, so
(B, 1, N, 2) boxes against (B, C, N) scores are not copied per class.
A row of N candidates takes 24·N bytes of shared memory: the wrapper raises
only above the card's opt-in limit less the kernel's static part, read once
per device (N up to ~9 600 on an H100; 2205 at size 672, 3645 at 864).

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

__all__ = ["nms_select", "postprocess_nms", "smem_bytes", "check_candidates", "smem_limit",
           "build", "SOURCE"]

SOURCE = _build.CSRC / "nms_select.cu"

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KERNEL = _build.Kernel(SOURCE, "yolo_nms_select", [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32,
                                                    _F32, _F32, _I32])
_SMEM_QUERY = _build.Kernel(SOURCE, "yolo_nms_select_smem_limit", [_PTR])
# shared memory a block may take, per device index: read from the card once
_SMEM_LIMITS: dict[int, int] = {}


def build():
    """Compile the kernel library if needed; returns its path."""
    return _build.build(SOURCE)


def smem_bytes(n: int) -> int:
    """Shared memory of one block for ``n`` candidates: four corners, the
    scores and the compacted list's indices, 4 bytes each."""
    return 6 * n * 4


def check_candidates(n: int, limit: int) -> None:
    """Raise unless ``n`` candidates fit a block's ``limit`` bytes of shared
    memory (the card's opt-in limit less the kernel's static part)."""
    if smem_bytes(n) > limit:
        raise ValueError(f"nms_select: {n} candidates need {smem_bytes(n)} B of shared memory "
                         f"per block, over the card's {limit}")


def smem_limit(t: torch.Tensor) -> int:
    """The shared memory a block may take on CUDA tensor ``t``'s device,
    read from the card on first use (which also opts the kernel in)."""
    index = t.get_device()
    if index not in _SMEM_LIMITS:
        limit = ctypes.c_int()
        _SMEM_QUERY(t, ctypes.addressof(limit))
        _SMEM_LIMITS[index] = limit.value
    return _SMEM_LIMITS[index]


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
    check_candidates(n, smem_limit(scores))
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
