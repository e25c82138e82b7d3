"""yolojax_torch — the PyTorch / CUDA port of yolojax.

The package mirrors ``yolojax/``'s module paths so that each counterpart is
easy to find, and keeps the JAX package's layouts at its public functions:
images go in as NHWC ``(B, H, W, 3)`` floats in [0, 1], the raw head is NHWC
``(B, H/32, W/32, A*(5+C))`` and ``PostProcessed`` is ``(B, C, K, ...)``.
Inside, convolutions run on NCHW tensors in ``channels_last`` memory format.

Where yolojax wrote a Pallas kernel for the TPU, the port has a kernel written
by hand for Hopper (``csrc/``), built with ``nvcc`` at first use and bound
with ``ctypes``.  Each kernel's wrapper launches it for a CUDA tensor and runs
its plain PyTorch version only for a tensor on the CPU.

The port imports ``torch`` and never ``jax``.  It reuses, unchanged, the
yolojax modules that import no jax: ``yolojax.config``, ``yolojax.category``,
``yolojax.utils.visualize`` and ``yolojax.cli`` (``make_parser``, ``setup``).
"""

__version__ = "0.1.0"
