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

The port imports ``torch`` and nothing of ``jax`` or of the ``yolojax``
package: what it needs of yolojax's jax-free modules it keeps as its own
copies (``config``, ``category``, ``cli``, ``utils.visualize``), which
``tests/test_torch_config.py`` holds equal to the originals.  Config values
that name ``yolojax.`` code are strings that ``config.parse_attr`` resolves
to the port's counterparts.
"""

__version__ = "0.1.0"
