"""Pure tensor numerics of the port: iou, box decode, nms, postprocess, reorg."""

from .nms import nms_mask, nms_topk  # noqa: F401
