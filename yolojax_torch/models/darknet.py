"""Darknet-19 YOLOv2 and Tiny-Darknet — counterpart of
``yolojax/models/darknet.py``.

The same plan tables as the JAX package (conv order = darknet ``.weights``
order):

* ``Darknet`` — the 19-conv trunk, the three-conv head, and the passthrough:
  the stride-16 feature through a 1×1 conv, reorg (``[model] reorg`` order),
  concatenated as ``[reorg, top]`` before the last 3×3 conv and the linear
  1×1 head conv;
* ``Tiny`` — tiny-yolo-voc: 9 convs with max pools, the last of them the
  stride-1 SAME pool after conv6, and no passthrough.

``_PlanModel`` is the base of every plan-driven model (``Darknet`` and
``Tiny`` here, ``MobileNet`` in ``mobilenet.py``), as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import LayerDef, ModelBase
from .engine import add_kernel_weights, fold_plan, plan_convs, resolve_in_channels, run_plan

__all__ = ["Darknet", "Tiny", "init_layer"]


def init_layer(d, generator: torch.Generator):
    """Fresh (params, BN state) of one conv: a He-normal OIHW weight, BN γ=1
    β=0 with running mean 0 / var 1, or a zero bias without BN (state {})."""
    fan_in = d.ksize * d.ksize * d.in_ch // d.groups
    w = torch.randn((d.out_ch, d.in_ch // d.groups, d.ksize, d.ksize),
                    generator=generator, dtype=torch.float32)
    p = {"w": w * math.sqrt(2.0 / fan_in)}
    zeros = torch.zeros(d.out_ch, dtype=torch.float32)
    if not d.bn:
        p["b"] = zeros
        return p, {}
    p["gamma"], p["beta"] = torch.ones_like(zeros), zeros.clone()
    return p, {"mean": zeros.clone(), "var": torch.ones_like(zeros)}


@dataclass
class _PlanModel(ModelBase):
    """A model described by its plan (``models/engine.py``): the subclass
    gives ``_build_plan``; init, the unfolded forward (training), BN folding
    and the folded forward follow."""

    def __post_init__(self):
        self.plan = self._build_plan()
        resolve_in_channels(self.plan, 3)

    @property
    def layer_defs(self):
        return plan_convs(self.plan)

    def init(self, generator: torch.Generator, device="cpu"):
        """Fresh (params, state) of every conv (:func:`init_layer`), drawn on
        the CPU from ``generator``, so a seed gives the same weights on every
        device."""
        params, state = {}, {}
        for d in self.layer_defs:
            params[d.name], s = init_layer(d, generator)
            if s:
                state[d.name] = s
        move = lambda tree: {k: {n: v.to(device) for n, v in lp.items()}
                             for k, lp in tree.items()}
        return move(params), move(state)

    def fold(self, params, state):
        """BN folded into the weights; weights in the compute dtype and
        ``channels_last`` (cuDNN's layout for them), biases f32, plus the
        layouts the selected kernels read (``engine.add_kernel_weights``)."""
        with torch.no_grad():
            folded = fold_plan(self.plan, params, state, self.bn)
            folded = {name: {"w": lp["w"].to(self.dtype).contiguous(
                              memory_format=torch.channels_last),
                          "b": lp["b"].to(torch.float32)}
                      for name, lp in folded.items()}
            add_kernel_weights(self.plan, folded, self.pallas)
            return folded

    def apply(self, params, state, images, train: bool = False, group=None):
        """images: (B, H, W, 3) in [0, 1] → (raw head (B, H/32, W/32,
        A*(5+C)), new BN state), on the unfolded params: batch statistics and
        a fresh state in train mode, the running state otherwise.  With
        ``group`` (a process group), the batch is this rank's share and the
        statistics are the global batch's.  Runs no kernel."""
        return run_plan(self.plan, params, images, state=state, bn=self.bn, train=train,
                        compute_dtype=self.dtype, reorg_order=self.reorg_order, group=group)

    def apply_folded(self, folded, images):
        """images: (B, H, W, 3) in [0, 1] → raw head (B, H/32, W/32, A*(5+C))."""
        return run_plan(self.plan, folded, images, compute_dtype=self.dtype,
                        reorg_order=self.reorg_order, pallas=self.pallas)


@dataclass
class Darknet(_PlanModel):
    """Darknet-19 YOLOv2 (the flagship model)."""

    def _build_plan(self):
        w = self.width
        c = lambda name, out, k, **kw: ("conv", LayerDef(name, w(name, out), k, **kw))
        pool = ("pool", 2, 2)
        return [
            c("c1", 32, 3), pool,
            c("c2", 64, 3), pool,
            c("c3", 128, 3), c("c4", 64, 1), c("c5", 128, 3), pool,
            c("c6", 256, 3), c("c7", 128, 1), c("c8", 256, 3), pool,
            c("c9", 512, 3), c("c10", 256, 1), c("c11", 512, 3),
            c("c12", 256, 1), c("c13", 512, 3),
            ("mark", "s16"), pool,
            c("c14", 1024, 3), c("c15", 512, 1), c("c16", 1024, 3),
            c("c17", 512, 1), c("c18", 1024, 3),
            # head (darknet cfg order: conv19, conv20, then route/conv21/reorg)
            c("c19", 1024, 3), c("c20", 1024, 3), ("mark", "top"),
            ("load", "s16"), c("c21", 64, 1), ("reorg", 2), ("concat", "top"),
            c("c22", 1024, 3),
            ("conv", LayerDef("out", self.out_channels, 1, bn=False, act=False)),
        ]


@dataclass
class Tiny(_PlanModel):
    """Tiny-Darknet (tiny-yolo-voc): 9 convs, no passthrough."""

    def _build_plan(self):
        w = self.width
        c = lambda name, out, k: ("conv", LayerDef(name, w(name, out), k))
        pool = ("pool", 2, 2)
        return [
            c("c1", 16, 3), pool,
            c("c2", 32, 3), pool,
            c("c3", 64, 3), pool,
            c("c4", 128, 3), pool,
            c("c5", 256, 3), pool,
            c("c6", 512, 3), ("pool", 2, 1),
            c("c7", 1024, 3), c("c8", 1024, 3),
            ("conv", LayerDef("out", self.out_channels, 1, bn=False, act=False)),
        ]
