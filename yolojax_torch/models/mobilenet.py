"""MobileNet-backbone YOLOv2 — counterpart of ``yolojax/models/mobilenet.py``.

The same plan table as the JAX package: a 3×3 stride-2 stem, then 13
depthwise-separable blocks (3×3 depthwise + 1×1 pointwise, each a folded
conv+bias+leaky) for an overall stride of 32, under Darknet's region head.
The passthrough source is the last stride-16 feature (pw11, 512 channels).

On the folded path the ``[model] pallas`` tokens ``dwsep`` and ``dwconv``
route the depthwise layers to the port's CUDA kernels (``engine.run_plan``).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import LayerDef
from .darknet import _PlanModel

__all__ = ["MobileNet"]

# (pointwise out channels, stride) for the 13 separable blocks
_BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]


@dataclass
class MobileNet(_PlanModel):
    """MobileNet-YOLOv2 (the ``config/mobilenet.ini`` model)."""

    def _build_plan(self):
        w = self.width
        plan = [("conv", LayerDef("stem", w("stem", 32), 3, stride=2))]
        for i, (out, stride) in enumerate(_BLOCKS, 1):
            # depthwise: groups=-1 resolves to in_ch in resolve_in_channels;
            # out_ch=-1 is a placeholder fixed to in_ch below
            plan.append(("conv", LayerDef(f"dw{i}", -1, 3, stride=stride, groups=-1)))
            plan.append(("conv", LayerDef(f"pw{i}", w(f"pw{i}", out), 1)))
        self._fix_depthwise(plan)
        # passthrough from the last stride-16 feature (pw11, 512 ch)
        idx = next(i for i, op in enumerate(plan) if op[0] == "conv" and op[1].name == "pw11")
        plan.insert(idx + 1, ("mark", "s16"))
        plan += [
            ("conv", LayerDef("c19", w("c19", 1024), 3)),
            ("conv", LayerDef("c20", w("c20", 1024), 3)), ("mark", "top"),
            ("load", "s16"), ("conv", LayerDef("c21", w("c21", 64), 1)),
            ("reorg", 2), ("concat", "top"),
            ("conv", LayerDef("c22", w("c22", 1024), 3)),
            ("conv", LayerDef("out", self.out_channels, 1, bn=False, act=False)),
        ]
        return plan

    @staticmethod
    def _fix_depthwise(plan):
        """Depthwise layers keep their input width: out_ch = running in_ch."""
        ch = None
        for op in plan:
            if op[0] != "conv":
                continue
            d = op[1]
            if d.out_ch == -1:
                d.out_ch = ch
            ch = d.out_ch
