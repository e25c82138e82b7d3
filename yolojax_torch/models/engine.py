"""Plan executor — counterpart of ``yolojax/models/engine.py`` (inference).

A model is an ordered plan of ops over one running tensor plus named slots:

    ("conv", LayerDef)        folded conv + bias (+ leaky) block
    ("pool", size, stride)    max pool: SAME at stride 1 (Tiny's tail pool),
                              VALID otherwise (``blocks.max_pool``)
    ("mark", key)             save the running tensor into slot ``key``
    ("load", key)             replace the running tensor with slot ``key``
    ("reorg", stride)         passthrough space-to-depth (ops/reorg.py)
    ("concat", key)           concat slot ``key`` after the running tensor

The running tensor is NCHW in ``channels_last`` memory (NHWC bytes), which is
what cuDNN's bf16 convolutions want; images come in NHWC, so the entry
``permute`` is a view.  Training (``train=True``) is not ported yet.

Kernel routing follows the JAX engine (``yolojax/models/engine.py:86-164``):
with ``dwsep`` selected, a depthwise 3×3 conv and the 1×1 conv after it run
as one fused kernel; with ``dwconv`` selected, a depthwise 3×3 conv that did
not pair runs in the depthwise kernel; with ``pool`` selected, a 2×2/2 pool
of lane-aligned channels and even H, W runs in the pool kernel; with
``reorg`` selected and the s2d order configured, the reorg runs in the s2d
kernel (the darknet order has no kernel).  The kernels take NHWC tensors,
which are the running tensor's own bytes, so both permutes around a call are
views.
"""

from __future__ import annotations

import torch

from ..kernels import dwconv as dwconv_k
from ..kernels import dwsep as dwsep_k
from ..kernels import pool as pool_k
from ..kernels import reorg as reorg_k
from ..ops.reorg import reorg
from . import LayerDef, kernel_active
from .blocks import BNConfig, conv_bias_leaky, fold_bn, max_pool

__all__ = ["plan_convs", "run_plan", "fold_plan", "resolve_in_channels", "add_kernel_weights"]

# the dwsep pair gate's bound on the input height (``engine.py:97``)
DWSEP_MAX_H = 40


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
            if d.groups == -1:  # depthwise marker
                d.groups = ch
            ch = d.out_ch
        elif kind == "mark":
            slots[op[1]] = ch
        elif kind == "load":
            ch = slots[op[1]]
        elif kind == "reorg":
            ch *= op[1] * op[1]
        elif kind == "concat":
            ch += slots[op[1]]


def _dw_routable(d: LayerDef) -> bool:
    """A depthwise 3×3 conv whose channels a depthwise kernel takes (the
    lane-aligned gate ``in_ch % 128 == 0`` of ``engine.py:97, 129``)."""
    return d.groups > 1 and d.ksize == 3 and d.in_ch % 128 == 0


def _pointwise_after(plan, i) -> LayerDef | None:
    """The 1×1 conv with leaky right after ``plan[i]``, which the dwsep kernel
    fuses with a depthwise conv there, or None."""
    nxt = plan[i + 1] if i + 1 < len(plan) else None
    if nxt and nxt[0] == "conv" and nxt[1].ksize == 1 and nxt[1].groups == 1 and nxt[1].act:
        return nxt[1]
    return None


def _dwsep_pair(plan, i, height: int) -> LayerDef | None:
    """Pointwise partner of the depthwise conv ``plan[i]`` when the pair goes
    to the dwsep kernel (``engine.py:92-106``): the dw conv has leaky and an
    input height ``≤ DWSEP_MAX_H``."""
    d = plan[i][1]
    if not (_dw_routable(d) and d.act and height <= DWSEP_MAX_H):
        return None
    return _pointwise_after(plan, i)


def _pool_routable(x, size: int, stride: int) -> bool:
    """A pool the pool kernel takes (``engine.py:146-148``): 2×2/2, channels
    a multiple of 128, H and W even.  ``x`` is NCHW-shaped, so C is
    ``x.shape[1]``, H ``x.shape[2]`` and W ``x.shape[3]`` (the JAX engine
    reads ``x.shape[-1]``, ``x.shape[1]`` and ``x.shape[2]`` of an NHWC array)."""
    return (size == 2 and stride == 2 and x.shape[1] % 128 == 0
            and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)


def run_plan(plan, folded, x, *, train: bool = False, compute_dtype=torch.bfloat16,
             reorg_order: str = "darknet", pallas: frozenset = frozenset()):
    """Execute the plan on folded ``{w, b}`` params.

    ``x``: (B, H, W, C) images → (B, h, w, C_out) NHWC output in the compute
    dtype.  The input is cast to the compute dtype before the first conv.
    ``pallas`` holds the ``[model] pallas`` tokens; a routed layer needs the
    weight layouts of :func:`add_kernel_weights` in ``folded``.
    """
    if train:
        raise NotImplementedError("training forward is not ported yet")
    use_dw_k = kernel_active("dwconv", pallas)
    use_dwsep = kernel_active("dwsep", pallas)
    use_pool_k = kernel_active("pool", pallas)
    use_reorg_k = kernel_active("reorg", pallas) and reorg_order == "s2d"
    slots = {}
    x = x.to(compute_dtype).permute(0, 3, 1, 2)
    skip = -1
    for i, op in enumerate(plan):
        if i == skip:
            continue
        kind = op[0]
        if kind == "conv":
            d = op[1]
            p = folded[d.name]
            # x is NCHW-shaped, so its height is x.shape[2] (the JAX engine
            # reads x.shape[1] of an NHWC array)
            n = _dwsep_pair(plan, i, x.shape[2]) if use_dwsep else None
            if n is not None:
                q = folded[n.name]
                x = dwsep_k.dwsep(x.permute(0, 2, 3, 1), p["taps"], p["b"], q["w_io"], q["b"],
                                  d.stride, q["w_oi"]).permute(0, 3, 1, 2)
                skip = i + 1
            elif use_dw_k and _dw_routable(d):
                x = dwconv_k.dwconv3x3(x.permute(0, 2, 3, 1), p["taps"], p["b"], d.stride,
                                       d.act).permute(0, 3, 1, 2)
            else:
                x = conv_bias_leaky(x, p["w"], p["b"], stride=d.stride, groups=d.groups,
                                    act=d.act)
        elif kind == "pool":
            if use_pool_k and _pool_routable(x, op[1], op[2]):
                x = pool_k.maxpool2x2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            else:
                x = max_pool(x, op[1], op[2])
        elif kind == "mark":
            slots[op[1]] = x
        elif kind == "load":
            x = slots[op[1]]
        elif kind == "reorg":
            if use_reorg_k:
                x = reorg_k.reorg_s2d(x.permute(0, 2, 3, 1), op[1]).permute(0, 3, 1, 2)
            else:
                x = reorg(x.permute(0, 2, 3, 1), op[1], reorg_order).permute(0, 3, 1, 2)
        elif kind == "concat":
            x = torch.cat([x, slots[op[1]]], dim=1).contiguous(
                memory_format=torch.channels_last)
        else:
            raise ValueError(f"unknown plan op {kind!r}")
    return x.permute(0, 2, 3, 1).contiguous()


def add_kernel_weights(plan, folded, pallas: frozenset) -> None:
    """Store, once, the weight layouts the selected kernels read, beside the
    OIHW ``w`` of each layer they may take: ``taps`` (3, 3, C) for a routable
    depthwise conv; for the 1×1 conv after it ``w_io`` (C, Cout), the JAX
    kernel's layout, and ``w_oi`` (Cout, C), which the bf16 dwsep kernel
    reads."""
    use_dw_k = kernel_active("dwconv", pallas)
    use_dwsep = kernel_active("dwsep", pallas)
    for i, op in enumerate(plan):
        if not (op[0] == "conv" and _dw_routable(op[1]) and (use_dw_k or use_dwsep)):
            continue
        lp = folded[op[1].name]
        lp["taps"] = lp["w"][:, 0].permute(1, 2, 0).contiguous()
        n = _pointwise_after(plan, i) if use_dwsep and op[1].act else None
        if n is not None:
            lq = folded[n.name]
            lq["w_oi"] = lq["w"][:, :, 0, 0].contiguous()
            lq["w_io"] = lq["w_oi"].t().contiguous()


def fold_plan(plan, params, state, bn: BNConfig):
    """Fold BN into conv weights for every block → inference-only params."""
    return {d.name: fold_bn(params[d.name], state.get(d.name, {}), bn)
            for d in plan_convs(plan)}
