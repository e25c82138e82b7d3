"""Folded conv + bias + LeakyReLU blocks — the inference half of
``yolojax/models/blocks.py``.

For inference, ``fold_bn`` folds the BN affine into the conv weights once, so
each block is one conv followed by bias and leaky.  The rounding points are
the JAX package's (``yolojax/models/blocks.py::conv_apply``): the conv output
is in the compute dtype, ``+ b`` and the leaky run in f32 (the bias is f32),
then the result is cast back to the compute dtype.

Layouts: activations NCHW (``channels_last`` memory on the hot path),
weights OIHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["BNConfig", "fold_bn", "leaky_relu", "bias_leaky", "conv_bias_leaky", "max_pool"]


def leaky_relu(x, slope=0.1):
    """Darknet's leaky activation (``x >= 0`` passes through)."""
    return torch.where(x >= 0, x, slope * x)


class BNConfig:
    """Batch-norm hyperparameters from the ``[batch_norm]`` section that
    inference reads; ``gamma`` / ``beta`` off means a fixed scale 1 / shift 0
    instead of the parameter.  (``momentum`` waits for the training port.)"""

    __slots__ = ("enable", "eps", "gamma", "beta")

    def __init__(self, enable: bool = True, eps: float = 1e-5, gamma: bool = True,
                 beta: bool = True):
        self.enable = enable
        self.eps = eps
        self.gamma = gamma
        self.beta = beta

    @classmethod
    def from_config(cls, config):
        if config is None or not config.has_section("batch_norm"):
            return cls()
        return cls(
            enable=config.getboolean("batch_norm", "enable", fallback=True),
            eps=config.getfloat("batch_norm", "eps", fallback=1e-5),
            gamma=config.getboolean("batch_norm", "gamma", fallback=True),
            beta=config.getboolean("batch_norm", "beta", fallback=True),
        )


def fold_bn(params: dict, state: dict, bn: BNConfig | None = None) -> dict:
    """Fold BN affine+stats into the conv → inference-only {w, b} params.

    w'[o] = w[o] * γ_o / √(σ²_o + ε);  b' = β − γ·μ/√(σ²+ε), with γ→1 and
    β→0 when the ``[batch_norm]`` toggles turn them off.
    """
    bn = bn or BNConfig()
    if "gamma" not in params or not bn.enable:
        out = {k: v for k, v in params.items() if k in ("w", "b")}
        out.setdefault("b", torch.zeros(params["w"].shape[0], dtype=torch.float32,
                                        device=params["w"].device))
        return out
    gamma = params["gamma"] if bn.gamma else 1.0
    beta = params["beta"] if bn.beta else 0.0
    scale = gamma / torch.sqrt(state["var"] + bn.eps)
    return {"w": params["w"] * scale[:, None, None, None],
            "b": beta - state["mean"] * scale}


def bias_leaky(y, b, act: bool = True):
    """Epilogue of a folded block: ``y`` (B, C, H, W) conv output in the
    compute dtype, ``+ b`` (f32) and leaky in f32, cast back to ``y``'s dtype
    (the folded-params case of ``yolojax/models/engine.py::_post_conv``)."""
    z = y.float() + b.view(1, -1, 1, 1)
    if act:
        z = leaky_relu(z)
    return z.to(y.dtype)


def conv_bias_leaky(x, w, b, *, stride: int = 1, groups: int = 1, act: bool = True):
    """Folded block: conv in the compute dtype (``x``'s and ``w``'s), then
    :func:`bias_leaky`.  Padding is symmetric ``k//2``."""
    y = F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2, groups=groups)
    return bias_leaky(y, b, act)


def max_pool(x, size: int = 2, stride: int | None = None):
    """Max pool of an NCHW ``x`` with darknet semantics, as
    ``yolojax/models/blocks.py::max_pool``: SAME for a stride-1 pool (Tiny's
    tail pool: -inf padding, ``(size - 1) // 2`` before and the rest after,
    so H and W stay), VALID otherwise."""
    stride = size if stride is None else stride
    if stride == 1:
        lo = (size - 1) // 2
        hi = size - 1 - lo
        x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, size, stride)
