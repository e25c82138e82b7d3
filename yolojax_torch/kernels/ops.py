"""The five forward kernels as ``torch.library`` custom ops, for
``torch.export``.

``torch.export`` traces with fake tensors, and a wrapper's launch reads
``data_ptr()`` through ``ctypes``, which a fake tensor does not have.  The
JAX package's ``jax.export`` carries its Pallas calls inside the exported
program; here each kernel becomes an op of the ``yolojax_torch`` namespace,
which the exported program calls by name:

* ``yolojax_torch::dwconv3x3`` — ``kernels/dwconv.py::dwconv3x3``;
* ``yolojax_torch::dwsep`` — ``kernels/dwsep.py::dwsep``;
* ``yolojax_torch::maxpool2x2`` — ``kernels/pool.py::maxpool2x2``, two
  outputs: the pooled tensor and, with ``full``, the epilogue output (an
  empty tensor without);
* ``yolojax_torch::reorg_s2d`` — ``kernels/reorg.py::reorg_s2d``;
* ``yolojax_torch::bias_leaky_nhwc`` —
  ``kernels/epilogue.py::bias_leaky_nhwc``.

An op's implementation is its wrapper: on a CUDA tensor the hand-written
kernel's launch (counted in the wrapper's ``launches``), on a CPU tensor the
plain version.  Its fake gives the output's shape, contiguous NHWC as the
wrapper allocates it.  The engine calls the ops only while ``torch.export``
traces (``torch.compiler.is_exporting()``); the eager forward launches the
wrappers directly and keeps their host time.

A saved program (``.pt2``) names these ops, so ``torch.export.load`` needs
this module imported first::

    import yolojax_torch.kernels.ops  # registers the ops
    program = torch.export.load("inference_416.pt2")
"""

from __future__ import annotations

import torch

from . import dwconv, dwsep as dwsep_k, epilogue, pool, reorg

__all__ = ["dwconv3x3", "dwsep", "maxpool2x2", "reorg_s2d", "bias_leaky_nhwc", "op_counts"]


@torch.library.custom_op("yolojax_torch::dwconv3x3", mutates_args=(),
                         schema="(Tensor x, Tensor w, Tensor b, int stride, bool act) -> Tensor")
def _dwconv3x3(x, w, b, stride, act):
    return dwconv.dwconv3x3(x, w, b, stride, act)


@_dwconv3x3.register_fake
def _(x, w, b, stride, act):
    bsz, h, wd, c = x.shape
    return x.new_empty((bsz, (h - 1) // stride + 1, (wd - 1) // stride + 1, c))


@torch.library.custom_op("yolojax_torch::dwsep", mutates_args=(),
                         schema="(Tensor x, Tensor wd, Tensor bd, Tensor wp, Tensor bp, "
                                "int stride, Tensor? wp_t) -> Tensor")
def _dwsep(x, wd, bd, wp, bp, stride, wp_t):
    return dwsep_k.dwsep(x, wd, bd, wp, bp, stride, wp_t)


@_dwsep.register_fake
def _(x, wd, bd, wp, bp, stride, wp_t):
    bsz, h, w, _ = x.shape
    return x.new_empty((bsz, (h - 1) // stride + 1, (w - 1) // stride + 1, wp.shape[1]))


@torch.library.custom_op("yolojax_torch::maxpool2x2", mutates_args=(),
                         schema="(Tensor x, Tensor? bias, bool act, bool full) -> "
                                "(Tensor, Tensor)")
def _maxpool2x2(x, bias, act, full):
    if full:
        return pool.maxpool2x2(x, bias, act, True)
    return pool.maxpool2x2(x, bias, act), x.new_empty(0)


@_maxpool2x2.register_fake
def _(x, bias, act, full):
    b, h, w, c = x.shape
    return x.new_empty((b, h // 2, w // 2, c)), x.new_empty((b, h, w, c) if full else 0)


@torch.library.custom_op("yolojax_torch::reorg_s2d", mutates_args=(),
                         schema="(Tensor x, int stride, Tensor? tail, Tensor? bias, bool act) "
                                "-> Tensor")
def _reorg_s2d(x, stride, tail, bias, act):
    return reorg.reorg_s2d(x, stride, tail, bias, act)


@_reorg_s2d.register_fake
def _(x, stride, tail, bias, act):
    b, h, w, c = x.shape
    ct = 0 if tail is None else tail.shape[-1]
    return x.new_empty((b, h // stride, w // stride, stride * stride * c + ct))


@torch.library.custom_op("yolojax_torch::bias_leaky_nhwc", mutates_args=(),
                         schema="(Tensor x, Tensor bias, bool act) -> Tensor")
def _bias_leaky_nhwc(x, bias, act):
    return epilogue.bias_leaky_nhwc(x, bias, act)


@_bias_leaky_nhwc.register_fake
def _(x, bias, act):
    return x.new_empty(x.shape)


def op_counts(graph) -> dict[str, int]:
    """Calls of this module's ops in an exported ``torch.fx`` graph, by kernel
    name (a target reads ``yolojax_torch.<name>.default``)."""
    counts: dict[str, int] = {}
    for node in graph.nodes:
        parts = str(node.target).split(".")
        if node.op == "call_function" and parts[0] == "yolojax_torch":
            counts[parts[1]] = counts.get(parts[1], 0) + 1
    return counts


# Callables with the wrappers' signatures and results, which the engine calls
# in their place while torch.export traces.

def dwconv3x3(x, w, b, stride: int = 1, act: bool = True):
    return torch.ops.yolojax_torch.dwconv3x3(x, w, b, stride, act)


def dwsep(x, wd, bd, wp, bp, stride: int = 1, wp_t=None):
    return torch.ops.yolojax_torch.dwsep(x, wd, bd, wp, bp, stride, wp_t)


def maxpool2x2(x, bias=None, act: bool = True, full: bool = False):
    y, out = torch.ops.yolojax_torch.maxpool2x2(x, bias, act, full)
    return (y, out) if full else y


def reorg_s2d(x, stride: int = 2, tail=None, bias=None, act: bool = True):
    return torch.ops.yolojax_torch.reorg_s2d(x, stride, tail, bias, act)


def bias_leaky_nhwc(x, bias, act: bool = True):
    return torch.ops.yolojax_torch.bias_leaky_nhwc(x, bias, act)
