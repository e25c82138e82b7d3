"""Pure tensor numerics of the port: iou, box decode, nms, postprocess, reorg."""
