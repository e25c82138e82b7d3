"""Conv + BatchNorm + LeakyReLU blocks — counterpart of
``yolojax/models/blocks.py``.

Training runs :func:`conv_apply` on unfolded ``{w, gamma, beta | b}`` params
and the BN running ``{mean, var}`` state: batch statistics in train mode,
returned as a new state (never mutated in place).  For inference,
``fold_bn`` folds the BN affine into the conv weights once, so each block is
one conv followed by bias and leaky.

The rounding points are the JAX package's (``conv_apply`` there): the conv
output is in the compute dtype; the BN statistics of a bf16 output are bf16
values (summed in f32, then rounded) and ``y − mean`` is a bf16 subtraction;
the scale and shift are f32, so the rest of the epilogue runs in f32, and
the result is cast back to the compute dtype.  Parameters stay f32 masters
and are cast inside the forward, so their gradients come back f32.

Across ranks (``group``, a ``torch.distributed`` process group) the train
mode's statistics are the global batch's, as ``jnp.mean`` / ``jnp.var`` over
a batch sharded on a mesh give them: each rank's f32 Σy, then its
Σ(y − mean)², summed over the group (``parallel/collectives.py``).  This is
not ``nn.SyncBatchNorm``, which updates the running variance with the
unbiased variance and rounds elsewhere.

Layouts: activations NCHW (``channels_last`` memory on the hot path),
weights OIHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_sum, world

__all__ = ["BNConfig", "conv_apply", "fold_bn", "leaky_relu", "bias_leaky", "conv",
           "conv_bias_leaky", "max_pool"]


def leaky_relu(x, slope=0.1):
    """Darknet's leaky activation (``x >= 0`` passes through, so the gradient
    at exactly 0 is 1, as the JAX package's; ``F.leaky_relu``'s is the
    slope)."""
    return torch.where(x >= 0, x, slope * x)


class BNConfig:
    """Batch-norm hyperparameters from the ``[batch_norm]`` section;
    ``gamma`` / ``beta`` off means a fixed scale 1 / shift 0 instead of the
    parameter (which stays in the params and gets a zero gradient);
    ``momentum`` is the weight of the batch statistic in the running update."""

    __slots__ = ("enable", "eps", "momentum", "gamma", "beta")

    def __init__(self, enable: bool = True, eps: float = 1e-5, momentum: float = 0.01,
                 gamma: bool = True, beta: bool = True):
        self.enable = enable
        self.eps = eps
        self.momentum = momentum
        self.gamma = gamma
        self.beta = beta

    @classmethod
    def from_config(cls, config):
        if config is None or not config.has_section("batch_norm"):
            return cls()
        return cls(
            enable=config.getboolean("batch_norm", "enable", fallback=True),
            eps=config.getfloat("batch_norm", "eps", fallback=1e-5),
            momentum=config.getfloat("batch_norm", "momentum", fallback=0.01),
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


def conv(x, w, *, stride: int = 1, groups: int = 1):
    """The conv of a folded block, without its epilogue: in the compute dtype
    (``x``'s and ``w``'s), symmetric padding ``k//2``."""
    return F.conv2d(x, w, stride=stride, padding=w.shape[-1] // 2, groups=groups)


def conv_bias_leaky(x, w, b, *, stride: int = 1, groups: int = 1, act: bool = True):
    """Folded block: :func:`conv`, then :func:`bias_leaky`."""
    return bias_leaky(conv(x, w, stride=stride, groups=groups), b, act)


def _global_moments(stats, group):
    """Per-channel mean and biased variance of NCHW ``stats`` over every
    rank's batch: Σy, then Σ(y − mean)², each summed over the group (the
    gradient flows back through both sums).  Every rank holds an equal
    share of the batch."""
    count = stats.numel() // stats.shape[1] * world(group)
    mean = all_reduce_sum(stats.sum(dim=(0, 2, 3)), group) / count
    sq = torch.square(stats - mean.view(1, -1, 1, 1)).sum(dim=(0, 2, 3))
    return mean, all_reduce_sum(sq, group) / count


def conv_apply(params: dict, state: dict, x, *, stride: int = 1, groups: int = 1,
               act: bool = True, bn: BNConfig | None = None, train: bool = False,
               compute_dtype=torch.bfloat16, group=None):
    """Conv → BN (or bias) → leaky on an NCHW ``x`` → (y, new_state).

    ``params``: f32 ``w`` (OIHW) and ``gamma``/``beta`` with BN or ``b``
    without.  In train mode BN normalizes by the batch's mean and *biased*
    variance and returns the running update ``(1−m)·old + m·batch``,
    detached (``F.batch_norm`` would update with the unbiased variance); in
    eval mode it uses the running state, which comes back unchanged.  With
    ``group``, the train mode's statistics are the global batch's
    (:func:`_global_moments`).
    """
    bn = bn or BNConfig()
    y = conv(x.to(compute_dtype), params["w"].to(compute_dtype), stride=stride, groups=groups)
    new_state = state
    if "gamma" in params and bn.enable:
        if train:
            stats = y.to(torch.promote_types(y.dtype, torch.float32))  # bf16 sums in f32
            if group is None:
                var, mean = torch.var_mean(stats, dim=(0, 2, 3), correction=0)
            else:
                mean, var = _global_moments(stats, group)
            mean, var = mean.to(y.dtype), var.to(y.dtype)
            m = bn.momentum
            new_state = {"mean": (1 - m) * state["mean"] + m * mean.detach(),
                         "var": (1 - m) * state["var"] + m * var.detach()}
        else:
            mean, var = state["mean"], state["var"]
        inv = torch.rsqrt(var + bn.eps)
        if bn.gamma:
            inv = inv * params["gamma"]
        y = (y - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1)
        y = y + (params["beta"].view(1, -1, 1, 1) if bn.beta else 0.0)
    elif "b" in params:
        y = y + params["b"].view(1, -1, 1, 1)
    if act:
        y = leaky_relu(y)
    return y.to(compute_dtype), new_state


def max_pool(x, size: int = 2, stride: int | None = None):
    """Max pool of an NCHW ``x`` with darknet semantics, as
    ``yolojax/models/blocks.py::max_pool``: SAME for a stride-1 pool (Tiny's
    tail pool: -inf padding, ``(size - 1) // 2`` before and the rest after,
    so H and W stay), VALID otherwise.  Its gradient goes to the first
    maximum of a window, as XLA's ``reduce_window`` gradient does."""
    stride = size if stride is None else stride
    if stride == 1:
        lo = (size - 1) // 2
        hi = size - 1 - lo
        x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, size, stride)
