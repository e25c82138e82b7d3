"""Inference wrapper — counterpart of ``yolojax/models/inference.py``:
backbone forward + decode, the detect path (forward → decode → per-class
NMS) shared by detect, eval and export, its host variant (NMS in the native
C++ library), and :func:`to_host`, which brings its output to the host.
The JAX package's ``detect_fn(mesh=…)``, the batch sharded over devices, is
one process per device here: each rank calls :meth:`Inference.detect_fn` on
its share of the batch and the picks meet on rank 0
(``cli/eval.py::run_eval``).

A detect call runs under the span ``yolojax_torch.detect`` (``utils/trace.py``;
recorded only while a profiler records), its forward under
``yolojax_torch.forward`` and the decode and NMS after it under
``yolojax_torch.post``."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.decode import Detections, decode, decode_flat
from ..ops.postprocess import PostProcessed, postprocess
from ..utils.trace import span
from . import kernel_active

__all__ = ["Inference", "to_host"]


class Inference:
    """Shared forward+decode for eval/detect/export paths."""

    def __init__(self, model):
        self.model = model
        self.anchors = torch.as_tensor(model.anchors, dtype=torch.float32)
        self._anchors_on = {}

    def _anchors(self, device) -> torch.Tensor:
        # kept per device: a host→device copy on every call would block the
        # host until the stream drains
        if device not in self._anchors_on:
            self._anchors_on[device] = self.anchors.to(device)
        return self._anchors_on[device]

    def fold(self, params, state):
        return self.model.fold(params, state)

    @torch.inference_mode()
    def __call__(self, folded, images) -> Detections:
        raw = self.model.apply_folded(folded, images)
        return decode(raw, self._anchors(raw.device))

    def detect_fn(self, threshold: float, overlap: float, topk: int):
        """(folded, images) → PostProcessed.

        With ``fusedpost`` selected (the default config) the raw head goes to
        the fused decode+NMS kernel, which takes precedence over ``nms``; with
        ``nms`` alone, decode → the batched NMS kernel
        (``kernels/nms.py::postprocess_nms``); with neither, decode → plain
        per-class NMS.
        """
        use_fused = kernel_active("fusedpost", self.model.pallas)
        use_nms = kernel_active("nms", self.model.pallas)

        @torch.inference_mode()
        def run(folded, images) -> PostProcessed:
            with span("yolojax_torch.detect", cuda=images.is_cuda, images=images.shape[0]):
                with span("yolojax_torch.forward"):
                    raw = self.model.apply_folded(folded, images)
                with span("yolojax_torch.post"):
                    anchors = self._anchors(raw.device)
                    if use_fused:
                        from ..kernels.postprocess_fused import postprocess_fused

                        return postprocess_fused(raw, anchors, threshold, overlap, topk)
                    det = decode(raw, anchors)
                    if use_nms:
                        from ..kernels.nms import postprocess_nms

                        return postprocess_nms(det, threshold, overlap, topk)
                    return postprocess(det, threshold, overlap, topk)

        return run

    def detect_fn_host(self, threshold: float, overlap: float, topk: int):
        """(folded, images) → PostProcessed as CPU tensors, with the NMS on the
        host (BASELINE config 1: "CPU forward + NMS"): the forward and the
        decode run on the model's device, the packed decode (``decode_flat``)
        comes to the host in one copy, and the native C++ greedy NMS
        (``native/nms.cpp``) takes the (image, class) problems over OpenMP
        threads.  The same packed contract as :meth:`detect_fn`."""
        from ..native import nms_native_batch

        @torch.inference_mode()
        def run(folded, images) -> PostProcessed:
            with span("yolojax_torch.detect", cuda=images.is_cuda, images=images.shape[0]):
                with span("yolojax_torch.forward"):
                    raw = self.model.apply_folded(folded, images)
                with span("yolojax_torch.post"):
                    flat = decode_flat(raw, self._anchors(raw.device)).cpu().numpy()
                    b, n, ch = flat.shape
                    c = ch - 5
                    boxes = flat[..., :4]                               # (B, N, 4)
                    scores = np.moveaxis(flat[..., 5:], -1, 1).reshape(b * c, n)
                    idx, conf, count = nms_native_batch(
                        np.broadcast_to(boxes[:, None], (b, c, n, 4)).reshape(b * c, n, 4),
                        scores, threshold, overlap, topk)
                    picked = boxes[np.arange(b)[:, None, None],
                                   idx.reshape(b, c, topk)]             # (B, C, K, 4)
                    keep = np.arange(topk) < count.reshape(b, c, 1)
                    return PostProcessed(*(torch.from_numpy(np.ascontiguousarray(v)) for v in (
                        picked[..., :2], picked[..., 2:], conf.reshape(b, c, topk), keep)))

        return run


def to_host(out: PostProcessed) -> PostProcessed:
    """``out`` as numpy arrays.  Where its fields are views of one allocation
    (the fused kernel's wrapper writes them so), the allocation comes over in
    one device→host copy, and the fields are rebuilt as views of it on the
    host; else each field is copied."""
    storage = out.conf.untyped_storage()
    if not all(t.untyped_storage().data_ptr() == storage.data_ptr() for t in out):
        return PostProcessed(*(t.cpu().numpy() for t in out))
    whole = torch.empty(0, dtype=torch.uint8, device=out.conf.device).set_(storage).cpu()
    host = whole.untyped_storage()
    return PostProcessed(*(torch.empty(0, dtype=t.dtype).set_(host, t.storage_offset(), t.shape,
                                                             t.stride()).numpy() for t in out))
