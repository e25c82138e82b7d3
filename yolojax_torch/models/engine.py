"""Plan executor — counterpart of ``yolojax/models/engine.py`` (inference).

A model is an ordered plan of ops over one running tensor plus named slots:

    ("conv", LayerDef)        folded conv + bias (+ leaky) block
    ("pool", size, stride)    VALID max pool (Darknet's 2×2/2)
    ("mark", key)             save the running tensor into slot ``key``
    ("load", key)             replace the running tensor with slot ``key``
    ("reorg", stride)         passthrough space-to-depth (ops/reorg.py)
    ("concat", key)           concat slot ``key`` after the running tensor

The running tensor is NCHW in ``channels_last`` memory (NHWC bytes), which is
what cuDNN's bf16 convolutions want; images come in NHWC, so the entry
``permute`` is a view.  Training (``train=True``) is not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.reorg import reorg
from . import LayerDef
from .blocks import BNConfig, conv_bias_leaky, fold_bn

__all__ = ["plan_convs", "run_plan", "fold_plan", "resolve_in_channels"]


def plan_convs(plan) -> list[LayerDef]:
    """Conv layers in plan order — also the darknet weight-file order."""
    return [op[1] for op in plan if op[0] == "conv"]


def resolve_in_channels(plan, in_ch: int) -> None:
    """Walk the plan symbolically to fill each LayerDef's ``in_ch`` (pruned
    widths propagate: downstream in_ch derives from upstream out_ch)."""
    ch = in_ch
    slots: dict[str, int] = {}
    for op in plan:
        kind = op[0]
        if kind == "conv":
            d = op[1]
            d.in_ch = ch
            ch = d.out_ch
        elif kind == "mark":
            slots[op[1]] = ch
        elif kind == "load":
            ch = slots[op[1]]
        elif kind == "reorg":
            ch *= op[1] * op[1]
        elif kind == "concat":
            ch += slots[op[1]]


def run_plan(plan, folded, x, *, train: bool = False, compute_dtype=torch.bfloat16,
             reorg_order: str = "darknet"):
    """Execute the plan on folded ``{w, b}`` params.

    ``x``: (B, H, W, C) images → (B, h, w, C_out) NHWC output in the compute
    dtype.  The input is cast to the compute dtype before the first conv.
    """
    if train:
        raise NotImplementedError("training forward is not ported yet")
    slots = {}
    x = x.to(compute_dtype).permute(0, 3, 1, 2)
    for op in plan:
        kind = op[0]
        if kind == "conv":
            d = op[1]
            p = folded[d.name]
            x = conv_bias_leaky(x, p["w"], p["b"], stride=d.stride, groups=d.groups,
                                act=d.act)
        elif kind == "pool":
            x = F.max_pool2d(x, op[1], op[2])
        elif kind == "mark":
            slots[op[1]] = x
        elif kind == "load":
            x = slots[op[1]]
        elif kind == "reorg":
            x = reorg(x.permute(0, 2, 3, 1), op[1], reorg_order).permute(0, 3, 1, 2)
        elif kind == "concat":
            x = torch.cat([x, slots[op[1]]], dim=1).contiguous(
                memory_format=torch.channels_last)
        else:
            raise ValueError(f"unknown plan op {kind!r}")
    return x.permute(0, 2, 3, 1).contiguous()


def fold_plan(plan, params, state, bn: BNConfig):
    """Fold BN into conv weights for every block → inference-only params."""
    return {d.name: fold_bn(params[d.name], state.get(d.name, {}), bn)
            for d in plan_convs(plan)}
