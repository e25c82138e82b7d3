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
``yolojax_torch.post`` (a WordTree head's under ``yolojax_torch.post.tree``
inside it)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.decode import Detections, decode, decode_flat
from ..ops.postprocess import PostProcessed, postprocess
from ..utils.trace import span
from . import kernel_active
from .engine import launches, route

__all__ = ["Inference", "to_host", "POST_LAUNCHES"]

# the kernel launches of one call of each post step (the wrappers count them)
POST_LAUNCHES = {"tree": {"tree_decode": 2}, "fused": {"postprocess_fused": 1},
                 "nms": {"nms_select": 1}, "plain": {}}


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

    def post_step(self) -> str:
        """The post step :meth:`detect_fn` runs: "tree" for a model with a
        WordTree head (``model.tree``) whatever the tokens say; else "fused"
        with ``fusedpost`` selected (the default config), which takes
        precedence over ``nms``; "nms" with ``nms`` alone; "plain" with
        neither."""
        if getattr(self.model, "tree", None) is not None:
            return "tree"
        if kernel_active("fusedpost", self.model.pallas):
            return "fused"
        return "nms" if kernel_active("nms", self.model.pallas) else "plain"

    def launches(self, size: int, post: bool = True) -> dict[str, int]:
        """The hand-written kernels' launches of one :meth:`detect_fn` call on
        ``size``² images, by kernel name: the forward's, from the engine's
        route (``engine.route``), and with ``post`` the post step's
        (:data:`POST_LAUNCHES`)."""
        m = self.model
        steps = route(m.plan, pallas=m.pallas, reorg_order=m.reorg_order, dtype=m.dtype,
                      channels=3, height=size, width=size)
        return {**launches(steps), **(POST_LAUNCHES[self.post_step()] if post else {})}

    def detect_fn(self, threshold: float, overlap: float, topk: int):
        """(folded, images) → PostProcessed, or TreePostProcessed for a
        model with a WordTree head, after the post step of
        :meth:`post_step`: the tree decode + per-node NMS (``kernels/tree.py``,
        under the span ``yolojax_torch.post.tree``); the fused decode+NMS
        kernel; decode → the batched NMS kernel
        (``kernels/nms.py::postprocess_nms``); or decode → plain per-class
        NMS.
        """
        post = self.post_step()

        @torch.inference_mode()
        def run(folded, images) -> PostProcessed:
            with span("yolojax_torch.detect", cuda=images.is_cuda, images=images.shape[0]):
                with span("yolojax_torch.forward"):
                    raw = self.model.apply_folded(folded, images)
                with span("yolojax_torch.post"):
                    anchors = self._anchors(raw.device)
                    if post == "tree":
                        from ..kernels.tree import tree_decode

                        b, h, w, _ = raw.shape
                        with span("yolojax_torch.post.tree", boxes=b * h * w * len(anchors)):
                            return tree_decode(raw, anchors, self.model.tree, threshold, overlap,
                                               topk, self.model.hier_thresh)
                    if post == "fused":
                        from ..kernels.postprocess_fused import postprocess_fused

                        return postprocess_fused(raw, anchors, threshold, overlap, topk)
                    det = decode(raw, anchors)
                    if post == "nms":
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

        if getattr(self.model, "tree", None) is not None:
            raise ValueError("detect_fn_host: the host NMS is per class; a WordTree head "
                             "takes detect_fn")

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


def to_host(out):
    """``out`` (a PostProcessed or a TreePostProcessed) as numpy arrays of
    the same type.  Where its fields are views of one allocation (the
    kernels' wrappers write them so), the allocation comes over in one
    device→host copy, and the fields are rebuilt as views of it on the host;
    else each field is copied."""
    storage = out[0].untyped_storage()
    if not all(t.untyped_storage().data_ptr() == storage.data_ptr() for t in out):
        return type(out)(*(t.cpu().numpy() for t in out))
    whole = torch.empty(0, dtype=torch.uint8, device=out[0].device).set_(storage).cpu()
    host = whole.untyped_storage()
    return type(out)(*(torch.empty(0, dtype=t.dtype).set_(host, t.storage_offset(), t.shape,
                                                         t.stride()).numpy() for t in out))
