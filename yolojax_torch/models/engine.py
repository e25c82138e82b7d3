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
``permute`` is a view.

Two forwards share the plan: the folded inference path (:func:`run_plan`
without ``state``), which the kernels below serve, and the unfolded path
(:func:`run_plan` with ``state``), which runs ``{w, gamma, beta | b}``
params and the BN state through ``blocks.conv_apply`` — in train mode with
batch statistics — and routes no kernel, as the JAX engine routes none when
``train=True`` (``yolojax/models/engine.py:86-90``: its Pallas kernels have
no backward).

Kernel routing follows the JAX engine (``yolojax/models/engine.py:86-164``):
with ``dwsep`` selected, a depthwise 3×3 conv and the 1×1 conv after it run
as one fused kernel; with ``dwconv`` selected, a depthwise 3×3 conv that did
not pair runs in the depthwise kernel; with ``pool`` selected, a 2×2/2 pool
of lane-aligned channels and even H, W runs in the pool kernel; with
``reorg`` selected and the s2d order configured, the reorg runs in the s2d
kernel (the darknet order has no kernel).  The kernels take NHWC tensors,
which are the running tensor's own bytes, so both permutes around a call are
views.

Where routing goes further than the JAX engine's:

* a conv on cuDNN followed by a routed pool, directly or with one ``mark``
  between, hands its raw output and bias to the pool kernel, which runs the
  conv's bias + leaky epilogue (and, for the mark, writes its full-resolution
  output into the slot); a conv followed by a routed reorg does the same with
  the reorg kernel, which also writes the ``concat`` right after it.  Both
  compute what the unfused ops compute, bit for bit;
* while ``torch.export`` traces, the routed layers call the kernels' custom
  ops (``kernels/ops.py``), which carry the same launches into the exported
  program; the eager forward calls the wrappers directly;
* in bf16 a depthwise pair wider than ``dwsep.MAX_BF16_CHANNELS`` does not
  go to the dwsep kernel (the JAX engine's ``engine.py:92-106`` routes it)
  but takes the unpaired route, which computes the same function.
"""

from __future__ import annotations

import torch

from ..kernels import dwconv as dwconv_k
from ..kernels import dwsep as dwsep_k
from ..kernels import ops as kernel_ops
from ..kernels import pool as pool_k
from ..kernels import reorg as reorg_k
from ..ops.reorg import reorg
from . import LayerDef, kernel_active
from .blocks import BNConfig, bias_leaky, conv, conv_apply, fold_bn, max_pool

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


def _dwsep_pair(plan, i, height: int, dtype) -> LayerDef | None:
    """Pointwise partner of the depthwise conv ``plan[i]`` when the pair goes
    to the dwsep kernel (``engine.py:92-106``): the dw conv has leaky and an
    input height ``≤ DWSEP_MAX_H``; in bf16 its channels are at most
    ``dwsep.MAX_BF16_CHANNELS``, which the JAX engine does not ask."""
    d = plan[i][1]
    if not (_dw_routable(d) and d.act and height <= DWSEP_MAX_H):
        return None
    if dtype == torch.bfloat16 and d.in_ch > dwsep_k.MAX_BF16_CHANNELS:
        return None
    return _pointwise_after(plan, i)


def _pool_routable(x, size: int, stride: int) -> bool:
    """A pool the pool kernel takes (``engine.py:146-148``): 2×2/2, channels
    a multiple of 128, H and W even.  ``x`` is NCHW-shaped, so C is
    ``x.shape[1]``, H ``x.shape[2]`` and W ``x.shape[3]`` (the JAX engine
    reads ``x.shape[-1]``, ``x.shape[1]`` and ``x.shape[2]`` of an NHWC array)."""
    return (size == 2 and stride == 2 and x.shape[1] % 128 == 0
            and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)


def _after_conv(plan, i):
    """What follows the conv ``plan[i]``, for the kernels that take its
    epilogue: (the key of a ``mark`` right after it or None, the index of the
    next other op, that op or None)."""
    j, key = i + 1, None
    if j < len(plan) and plan[j][0] == "mark":
        key, j = plan[j][1], j + 1
    return key, j, plan[j] if j < len(plan) else None


def _launchers():
    """The four forward kernels' entry points (dwconv3x3, dwsep, maxpool2x2,
    reorg_s2d): their custom ops while ``torch.export`` traces, the wrappers
    otherwise."""
    if torch.compiler.is_exporting():
        return kernel_ops.dwconv3x3, kernel_ops.dwsep, kernel_ops.maxpool2x2, kernel_ops.reorg_s2d
    return dwconv_k.dwconv3x3, dwsep_k.dwsep, pool_k.maxpool2x2, reorg_k.reorg_s2d


def run_plan(plan, params, x, *, state: dict | None = None, bn: BNConfig | None = None,
             train: bool = False, compute_dtype=torch.bfloat16, reorg_order: str = "darknet",
             pallas: frozenset = frozenset(), group=None):
    """Execute the plan.

    ``x``: (B, H, W, C) images → (B, h, w, C_out) NHWC output in the compute
    dtype.  The input is cast to the compute dtype before the first conv.

    Without ``state``, ``params`` are folded ``{w, b}`` params and the
    output is returned; ``pallas`` holds the ``[model] pallas`` tokens, and a
    routed layer needs the weight layouts of :func:`add_kernel_weights` in
    them.  With ``state`` (BN running stats), ``params`` are the unfolded
    params and the result is ``(output, new_state)``; ``train`` selects
    batch statistics, which are the global batch's over ``group`` (a process
    group, ``blocks.conv_apply``) where one is given.
    """
    if state is not None:
        return _run_unfolded(plan, params, state, x, bn=bn or BNConfig(), train=train,
                             compute_dtype=compute_dtype, reorg_order=reorg_order, group=group)
    if train:
        raise ValueError("a train-mode forward needs the BN state (run_plan(..., state=...))")
    folded = params
    use_dw_k = kernel_active("dwconv", pallas)
    use_dwsep = kernel_active("dwsep", pallas)
    use_pool_k = kernel_active("pool", pallas)
    use_reorg_k = kernel_active("reorg", pallas) and reorg_order == "s2d"
    dwconv3x3, dwsep, maxpool2x2, reorg_s2d = _launchers()
    slots = {}
    x = x.to(compute_dtype).permute(0, 3, 1, 2)
    resume = 0   # ops before this index ran fused into an earlier one
    for i, op in enumerate(plan):
        if i < resume:
            continue
        kind = op[0]
        if kind == "conv":
            d = op[1]
            p = folded[d.name]
            # x is NCHW-shaped, so its height is x.shape[2] (the JAX engine
            # reads x.shape[1] of an NHWC array)
            n = _dwsep_pair(plan, i, x.shape[2], x.dtype) if use_dwsep else None
            if n is not None:
                q = folded[n.name]
                x = dwsep(x.permute(0, 2, 3, 1), p["taps"], p["b"], q["w_io"], q["b"], d.stride,
                          q["w_oi"]).permute(0, 3, 1, 2)
                resume = i + 2
                continue
            if use_dw_k and _dw_routable(d):
                x = dwconv3x3(x.permute(0, 2, 3, 1), p["taps"], p["b"], d.stride,
                              d.act).permute(0, 3, 1, 2)
                continue
            y = conv(x, p["w"], stride=d.stride, groups=d.groups)
            key, j, nxt = _after_conv(plan, i)
            if (use_pool_k and nxt is not None and nxt[0] == "pool"
                    and _pool_routable(y, nxt[1], nxt[2])):
                out = maxpool2x2(y.permute(0, 2, 3, 1), p["b"], d.act, key is not None)
                if key is not None:
                    out, full = out
                    slots[key] = full.permute(0, 3, 1, 2)
                x = out.permute(0, 3, 1, 2)
                resume = j + 1
            elif use_reorg_k and key is None and nxt is not None and nxt[0] == "reorg":
                cat = plan[j + 1] if j + 1 < len(plan) and plan[j + 1][0] == "concat" else None
                tail = None if cat is None else slots[cat[1]].permute(0, 2, 3, 1)
                x = reorg_s2d(y.permute(0, 2, 3, 1), nxt[1], tail, p["b"],
                              d.act).permute(0, 3, 1, 2)
                resume = j + 1 if cat is None else j + 2
            else:
                x = bias_leaky(y, p["b"], d.act)
        elif kind == "pool":
            if use_pool_k and _pool_routable(x, op[1], op[2]):
                x = maxpool2x2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            else:
                x = max_pool(x, op[1], op[2])
        elif kind == "mark":
            slots[op[1]] = x
        elif kind == "load":
            x = slots[op[1]]
        elif kind == "reorg":
            if use_reorg_k:
                x = reorg_s2d(x.permute(0, 2, 3, 1), op[1]).permute(0, 3, 1, 2)
            else:
                x = reorg(x.permute(0, 2, 3, 1), op[1], reorg_order).permute(0, 3, 1, 2)
        elif kind == "concat":
            x = torch.cat([x, slots[op[1]]], dim=1).contiguous(
                memory_format=torch.channels_last)
        else:
            raise ValueError(f"unknown plan op {kind!r}")
    return x.permute(0, 2, 3, 1).contiguous()


def _run_unfolded(plan, params, state, x, *, bn: BNConfig, train: bool, compute_dtype,
                  reorg_order: str, group=None):
    """The unfolded forward → (output, new_state): every conv through
    ``conv_apply``, no kernel.  ``new_state`` holds a fresh (detached) entry
    for each BN layer in train mode and the given one otherwise."""
    slots = {}
    new_state = dict(state)
    x = x.to(compute_dtype).permute(0, 3, 1, 2)
    for op in plan:
        kind = op[0]
        if kind == "conv":
            d = op[1]
            x, ns = conv_apply(params[d.name], state.get(d.name, {}), x, stride=d.stride,
                               groups=d.groups, act=d.act, bn=bn, train=train,
                               compute_dtype=compute_dtype, group=group)
            if ns:
                new_state[d.name] = ns
        elif kind == "pool":
            x = max_pool(x, op[1], op[2])
        elif kind == "mark":
            slots[op[1]] = x
        elif kind == "load":
            x = slots[op[1]]
        elif kind == "reorg":
            x = reorg(x.permute(0, 2, 3, 1), op[1], reorg_order).permute(0, 3, 1, 2)
        elif kind == "concat":
            x = torch.cat([x, slots[op[1]]], dim=1)
        else:
            raise ValueError(f"unknown plan op {kind!r}")
    return x.permute(0, 2, 3, 1).contiguous(), new_state


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
