"""Tools of the port: darknet ``.weights`` import and export, anchor k-means,
ONNX emission, channel pruning, and the kernel-time measurement that runs on
the card."""
