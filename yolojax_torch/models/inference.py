"""Inference wrapper — counterpart of ``yolojax/models/inference.py``:
backbone forward + decode, and the detect path (forward → decode →
per-class NMS) shared by detect, eval and export."""

from __future__ import annotations

import torch

from ..ops.decode import Detections, decode
from ..ops.postprocess import PostProcessed, postprocess
from . import kernel_active

__all__ = ["Inference"]


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
            if use_fused:
                from ..kernels.postprocess_fused import postprocess_fused

                raw = self.model.apply_folded(folded, images)
                return postprocess_fused(raw, self._anchors(raw.device), threshold,
                                         overlap, topk)
            det = self(folded, images)
            if use_nms:
                from ..kernels.nms import postprocess_nms

                return postprocess_nms(det, threshold, overlap, topk)
            return postprocess(det, threshold, overlap, topk)

        return run
