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

The folded walk's route is a value: :func:`route` computes its steps from
the plan, the tokens and the input's shape, :func:`run_plan` runs them, and
:func:`launches` counts their kernel launches.  Kernel routing follows the
JAX engine (``yolojax/models/engine.py:86-164``): with ``dwsep`` selected, a
depthwise 3×3 conv and the 1×1 conv after it run as one fused kernel; with
``dwconv`` selected, a depthwise 3×3 conv that did not pair runs in the
depthwise kernel; with ``reorg`` selected and the s2d order configured, the
reorg runs in the s2d kernel (the darknet order has no kernel).  The kernels
take NHWC tensors, which are the running tensor's own bytes, so both
permutes around a call are views.

Where routing goes further than the JAX engine's:

* every 2×2/2 pool of even H and W runs in the pool kernel, under any
  ``[model] pallas`` tokens and at any channel count: a conv on cuDNN
  followed by such a pool, directly or with one ``mark`` between, hands its
  raw output and bias to the kernel, which runs the conv's bias + leaky
  epilogue (and, for the mark, writes its full-resolution output into the
  slot); a pool that follows no conv runs in it bare.  The JAX engine
  routes a pool only under ``pool`` and at lane-aligned channels
  (``yolojax/models/engine.py:146-148``) and leaves the rest to XLA, which
  fuses the epilogue into ``reduce_window``; the routing differs, the
  function is the same.  A stride-1 pool or an odd H or W runs
  ``max_pool``, after the epilogue kernel;
* a conv followed by a routed reorg hands its raw output and bias to the
  reorg kernel, which runs the epilogue and also writes the ``concat`` right
  after it.  Both fused kernels compute what the unfused ops compute, bit
  for bit;
* a conv whose epilogue no kernel takes runs it in the one-pass epilogue
  kernel (``kernels/epilogue.py``), bit for bit ``blocks.bias_leaky``'s
  result, under no ``[model] pallas`` token: the counterpart of the epilogue
  that XLA always fuses into the JAX engine's conv.  On the CPU the wrapper
  runs ``bias_leaky`` itself, and the unfolded path never reaches it.  Where
  such a conv's ``out_ch`` is not a multiple of ``PAD`` (every head: 125,
  425, 28 269), cuDNN runs it at the padded width of :func:`padded_width`
  on a weight whose extra rows are zeros (``w_pad``,
  :func:`add_kernel_weights`), and the epilogue reads the first ``out_ch``
  channels of that output: an odd width leaves cuDNN on an sm75 GEMM at
  one-element alignment (on an H100 the 1024 → 28 269 head ran at ~10 % of
  its peak) and the epilogue kernel on one lane a thread.  The real
  channels' sums, and so the result, are the unpadded conv's;
* while ``torch.export`` traces, the routed layers call the kernels' custom
  ops (``kernels/ops.py``), which carry the same launches into the exported
  program; the eager forward calls the wrappers directly;
* in bf16 a depthwise pair wider than ``dwsep.MAX_BF16_CHANNELS`` does not
  go to the dwsep kernel (the JAX engine's ``engine.py:92-106`` routes it)
  but takes the unpaired route, which computes the same function.

Each op of the folded walk runs under a span of ``utils/trace.py``
(``yolojax_torch.plan.<op>``: ``layout`` for the entry cast and the exit
copy, ``conv``, ``epilogue``, ``pool``, ``reorg``, ``concat``, ``dwconv``,
``dwsep``; a fused kernel's span holds the epilogue it takes; a padded
conv's span carries ``padded=<width>`` beside ``layer=``), which records
only while a profiler does; ``mark`` and ``load`` record nothing, nor does
the unfolded walk.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from ..kernels import dwconv as dwconv_k
from ..kernels import dwsep as dwsep_k
from ..kernels import epilogue as epilogue_k
from ..kernels import ops as kernel_ops
from ..kernels import pool as pool_k
from ..kernels import reorg as reorg_k
from ..ops.reorg import reorg
from ..utils.trace import span
from . import LayerDef, kernel_active
from .blocks import BNConfig, conv, conv_apply, fold_bn, max_pool

__all__ = ["plan_convs", "run_plan", "fold_plan", "resolve_in_channels", "add_kernel_weights",
           "route", "launches", "padded_width", "Step"]

# the dwsep pair gate's bound on the input height (``engine.py:97``)
DWSEP_MAX_H = 40
# a padded conv's output width is a multiple of PAD: a pixel row of 16 bytes' multiple in bf16
PAD = 8
# the span of each step of the folded walk but mark and load, which record none
_SPANS = {op: f"yolojax_torch.plan.{op}"
          for op in ("conv", "epilogue", "pool", "reorg", "concat", "dwconv", "dwsep")}


def plan_convs(plan) -> list[LayerDef]:
    """Conv layers in plan order — also the darknet weight-file order."""
    return [op[1] for op in plan if op[0] == "conv"]


def _walk(plan, channels: int, height: int, width: int) -> list[tuple[int, int, int]]:
    """The running tensor's (C, H, W) before each op of the plan and after
    the last, walked symbolically: a conv gives its ``out_ch`` and
    ``(h - 1) // stride + 1``; a VALID pool ``(h - size) // stride + 1`` (``h
    // 2`` at 2×2/2) and a SAME stride-1 pool ``h``; a reorg ``C·s²`` and ``h
    // s``; a concat adds the slot's channels; ``mark`` and ``load`` save and
    restore the slots."""
    shape, slots, shapes = (channels, height, width), {}, []
    for op in plan:
        shapes.append(shape)
        kind, (c, h, w) = op[0], shape
        if kind == "conv":
            s = op[1].stride
            shape = (op[1].out_ch, (h - 1) // s + 1, (w - 1) // s + 1)
        elif kind == "pool":
            size, s = op[1], op[2]
            if s != 1:
                shape = (c, (h - size) // s + 1, (w - size) // s + 1)
        elif kind == "mark":
            slots[op[1]] = shape
        elif kind == "load":
            shape = slots[op[1]]
        elif kind == "reorg":
            s = op[1]
            shape = (c * s * s, h // s, w // s)
        elif kind == "concat":
            shape = (c + slots[op[1]][0], h, w)
        else:
            raise ValueError(f"unknown plan op {kind!r}")
    shapes.append(shape)
    return shapes


def resolve_in_channels(plan, in_ch: int) -> None:
    """Fill each LayerDef's ``in_ch`` from the symbolic walk (pruned widths
    propagate: downstream in_ch derives from upstream out_ch)."""
    for op, (c, _, _) in zip(plan, _walk(plan, in_ch, 0, 0)):
        if op[0] == "conv":
            d = op[1]
            d.in_ch = c
            if d.groups == -1:  # depthwise marker
                d.groups = c


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


def padded_width(d: LayerDef) -> int | None:
    """The width a conv runs at on cuDNN where its epilogue goes to
    ``bias_leaky_nhwc``: ``out_ch`` rounded up to a multiple of ``PAD``
    where it is not one; None for a multiple, or a grouped conv (whose
    output channels its groups fix)."""
    if d.groups != 1 or d.out_ch % PAD == 0:
        return None
    return -(-d.out_ch // PAD) * PAD


def _pool_kernel_takes(size: int, stride: int, height: int, width: int) -> bool:
    """A pool that runs in ``maxpool2x2``, at any channel count: 2×2/2 over
    an even H and W."""
    return size == 2 and stride == 2 and height % 2 == 0 and width % 2 == 0


class Step(NamedTuple):
    """One step of the folded walk (:func:`route`).

    ``op`` names its span, ``yolojax_torch.plan.<op>`` (``mark`` and ``load``
    record none); ``kernel`` the hand-written kernel it launches, None where
    it runs on cuDNN or in torch or launches nothing; ``layer`` the conv it
    runs or whose raw output and bias it takes (its span's ``layer=``), None
    for an op of its own; ``shape`` the (C, H, W) of the tensor it takes (the
    conv's raw output for an epilogue or a fused pool or reorg); ``key`` the
    slot it writes or reads (a fused pool's full output, a fused reorg's
    concat); ``arg`` a pool's (size, stride), a reorg's stride, a dwsep
    pair's 1×1 conv, a padded conv's width (:func:`padded_width`)."""

    op: str
    kernel: str | None = None
    layer: LayerDef | None = None
    shape: tuple = ()
    key: str | None = None
    arg: object = None


def route(plan, *, pallas: frozenset, reorg_order: str, dtype, channels: int, height: int,
          width: int) -> list[Step]:
    """The folded walk's steps in order on a (B, ``height``, ``width``,
    ``channels``) input in ``dtype``, under the ``[model] pallas`` tokens
    ``pallas``: what :func:`run_plan` runs, and the launches of a call
    (:func:`launches`).

    * A depthwise conv pairs with the 1×1 conv after it in ``dwsep`` under
      that token (:func:`_dwsep_pair`: input height ``≤ DWSEP_MAX_H``, the
      bf16 channel cap); else it runs in ``dwconv3x3`` under ``dwconv`` where
      its channels are lane-aligned.
    * Any other conv runs on cuDNN, then hands its raw output and bias to the
      kernel that takes its epilogue: ``maxpool2x2`` where a 2×2/2 pool of
      even H and W follows, directly or through one ``mark`` (whose slot
      gets the full output); ``reorg_s2d`` where a reorg follows under
      ``reorg`` in s2d order (with the ``concat`` right after it); else
      ``bias_leaky_nhwc``, and then the conv runs at its
      :func:`padded_width` where it has one.
    * A pool that follows no conv runs bare in ``maxpool2x2`` where it is
      2×2/2 over an even H and W, in ``max_pool`` otherwise; a reorg in
      ``reorg_s2d`` under ``reorg`` in s2d order, in torch otherwise.
    """
    use_dw_k = kernel_active("dwconv", pallas)
    use_dwsep = kernel_active("dwsep", pallas)
    use_reorg_k = kernel_active("reorg", pallas) and reorg_order == "s2d"
    shapes = _walk(plan, channels, height, width)
    steps, i, end = [], 0, len(plan)
    while i < end:
        op, shape = plan[i], shapes[i]
        kind, i = op[0], i + 1
        if kind == "conv":
            d = op[1]
            n = _dwsep_pair(plan, i - 1, shape[1], dtype) if use_dwsep else None
            if n is not None:
                steps.append(Step("dwsep", "dwsep", d, shape, arg=n))
                i += 1
                continue
            if use_dw_k and _dw_routable(d):
                steps.append(Step("dwconv", "dwconv3x3", d, shape))
                continue
            y = shapes[i]
            key = plan[i][1] if i < end and plan[i][0] == "mark" else None
            j = i + (key is not None)
            nxt = plan[j] if j < end else ("end",)
            if nxt[0] == "pool" and _pool_kernel_takes(nxt[1], nxt[2], y[1], y[2]):
                tail = Step("pool", "maxpool2x2", d, y, key=key)
                i = j + 1
            elif use_reorg_k and key is None and nxt[0] == "reorg":
                cat = plan[j + 1][1] if j + 1 < end and plan[j + 1][0] == "concat" else None
                tail = Step("reorg", "reorg_s2d", d, y, key=cat, arg=nxt[1])
                i = j + 1 + (cat is not None)
            else:
                tail = Step("epilogue", "bias_leaky_nhwc", d, y)
            pad = padded_width(d) if tail.op == "epilogue" else None
            steps += [Step("conv", None, d, shape, arg=pad), tail]
        elif kind == "pool":
            takes = _pool_kernel_takes(op[1], op[2], shape[1], shape[2])
            steps.append(Step("pool", "maxpool2x2" if takes else None, shape=shape, arg=op[1:]))
        elif kind == "reorg":
            steps.append(Step("reorg", "reorg_s2d" if use_reorg_k else None, shape=shape,
                              arg=op[1]))
        else:   # mark, load, concat
            steps.append(Step(kind, shape=shape, key=op[1]))
    return steps


def launches(steps) -> dict[str, int]:
    """The launches of each hand-written kernel over ``steps`` (a
    :func:`route`), by the kernel's name."""
    return dict(Counter(s.kernel for s in steps if s.kernel))


def _launchers():
    """The five forward kernels' entry points (dwconv3x3, dwsep, maxpool2x2,
    reorg_s2d, bias_leaky_nhwc): their custom ops while ``torch.export``
    traces, the wrappers otherwise."""
    if torch.compiler.is_exporting():
        return (kernel_ops.dwconv3x3, kernel_ops.dwsep, kernel_ops.maxpool2x2,
                kernel_ops.reorg_s2d, kernel_ops.bias_leaky_nhwc)
    return (dwconv_k.dwconv3x3, dwsep_k.dwsep, pool_k.maxpool2x2, reorg_k.reorg_s2d,
            epilogue_k.bias_leaky_nhwc)


def run_plan(plan, params, x, *, state: dict | None = None, bn: BNConfig | None = None,
             train: bool = False, compute_dtype=torch.bfloat16, reorg_order: str = "darknet",
             pallas: frozenset = frozenset(), group=None):
    """Execute the plan.

    ``x``: (B, H, W, C) images → (B, h, w, C_out) NHWC output in the compute
    dtype.  The input is cast to the compute dtype before the first conv.

    Without ``state``, ``params`` are folded ``{w, b}`` params and the
    output is returned; the walk runs the steps of :func:`route` at the
    input's shape, ``pallas`` holds the ``[model] pallas`` tokens, and a
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
    steps = route(plan, pallas=pallas, reorg_order=reorg_order, dtype=compute_dtype,
                  channels=x.shape[3], height=x.shape[1], width=x.shape[2])
    dwconv3x3, dwsep, maxpool2x2, reorg_s2d, bias_leaky_nhwc = _launchers()
    slots = {}
    with span("yolojax_torch.plan.layout"):
        x = x.to(compute_dtype).permute(0, 3, 1, 2)
    for s in steps:
        op, d = s.op, s.layer
        if op == "mark":
            slots[s.key] = x
            continue
        if op == "load":
            x = slots[s.key]
            continue
        p = None if d is None else folded[d.name]
        attrs = {} if d is None else {"layer": d.name}
        if op == "conv" and s.arg:
            attrs["padded"] = s.arg
        with span(_SPANS[op], **attrs):
            # the kernels take NHWC: the running tensor's own bytes, permuted views
            if op == "conv" and s.arg:      # the first out_ch channels of the padded output
                y = conv(x, p["w_pad"], stride=d.stride)[:, :d.out_ch]
            elif op == "conv":
                y = conv(x, p["w"], stride=d.stride, groups=d.groups)
            elif op == "epilogue":
                x = bias_leaky_nhwc(y.permute(0, 2, 3, 1), p["b"], d.act).permute(0, 3, 1, 2)
            elif op == "pool" and d is not None:
                out = maxpool2x2(y.permute(0, 2, 3, 1), p["b"], d.act, s.key is not None)
                if s.key is not None:
                    out, full = out
                    slots[s.key] = full.permute(0, 3, 1, 2)
                x = out.permute(0, 3, 1, 2)
            elif op == "pool":
                x = (maxpool2x2(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2) if s.kernel
                     else max_pool(x, *s.arg))
            elif op == "reorg" and d is not None:
                tail = None if s.key is None else slots[s.key].permute(0, 2, 3, 1)
                x = reorg_s2d(y.permute(0, 2, 3, 1), s.arg, tail, p["b"],
                              d.act).permute(0, 3, 1, 2)
            elif op == "reorg":
                x = (reorg_s2d(x.permute(0, 2, 3, 1), s.arg) if s.kernel
                     else reorg(x.permute(0, 2, 3, 1), s.arg, reorg_order)).permute(0, 3, 1, 2)
            elif op == "concat":
                x = torch.cat([x, slots[s.key]], dim=1).contiguous(
                    memory_format=torch.channels_last)
            elif op == "dwconv":
                x = dwconv3x3(x.permute(0, 2, 3, 1), p["taps"], p["b"], d.stride,
                              d.act).permute(0, 3, 1, 2)
            else:   # dwsep
                q = folded[s.arg.name]
                x = dwsep(x.permute(0, 2, 3, 1), p["taps"], p["b"], q["w_io"], q["b"],
                          d.stride, q["w_oi"]).permute(0, 3, 1, 2)
    with span("yolojax_torch.plan.layout"):
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
    """Store, once, the weight layouts the walk reads besides the OIHW
    ``w`` of each layer: ``w_pad`` for a conv that has a padded width
    (:func:`padded_width`: ``w``'s rows, then zero rows, ``channels_last``);
    for the selected kernels ``taps`` (3, 3, C) for a routable depthwise
    conv, and for the 1×1 conv after it ``w_io`` (C, Cout), the JAX kernel's
    layout, and ``w_oi`` (Cout, C), which the bf16 dwsep kernel reads."""
    for d in plan_convs(plan):
        pad = padded_width(d)
        if pad is not None:
            w = folded[d.name]["w"]
            folded[d.name]["w_pad"] = torch.cat(
                [w, w.new_zeros((pad - d.out_ch, *w.shape[1:]))]).contiguous(
                memory_format=torch.channels_last)
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
