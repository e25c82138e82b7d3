"""Hand-written Hopper kernels of the port, one module per TPU kernel, each
beside its plain PyTorch version.  Sources live in ``yolojax_torch/csrc/``;
``ops.py`` registers the forward kernels as custom ops for ``torch.export``."""
