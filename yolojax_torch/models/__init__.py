"""Model zoo of the port: config-driven backbones + region head.

Counterpart of ``yolojax/models/__init__.py``.  Every model follows one
protocol over plain dictionaries of tensors keyed by layer name:

* ``init(generator, device) -> (params, state)`` — f32 parameters and BN
  state, conv weights in torch's OIHW layout;
* ``apply(params, state, images, train) -> (raw, new_state)`` — the unfolded
  forward that training differentiates (batch statistics in train mode);
* ``fold(params, state) -> folded`` + ``apply_folded(folded, images)`` — the
  inference path with BatchNorm folded into the conv weights;
* ``layer_defs`` — the ordered conv table (darknet ``.weights`` order).

Kernel selection reuses the ``[model] pallas`` tokens of the JAX package.  A
token selects the port's hand-written CUDA kernel where one exists
(:data:`PORTED_KERNELS`); the others take the plain torch path, as the JAX
package does off the TPU.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import parse_attr, torch_dtype
from .blocks import BNConfig

__all__ = ["ChannelResolver", "LayerDef", "ModelBase", "build_model", "kernel_active",
           "PORTED_KERNELS"]

# ``[model] pallas`` tokens whose TPU kernel has a CUDA counterpart in the port
PORTED_KERNELS = frozenset({"fusedpost", "nms", "dwsep", "dwconv", "pool", "reorg"})


def kernel_active(which: str, enabled: frozenset) -> bool:
    """Is the kernel ``which`` selected by config and ported?

    The wrapper of a selected kernel launches it for a CUDA tensor and runs
    its plain version for a CPU tensor; an unported token selects nothing.
    """
    return which in enabled and which in PORTED_KERNELS


class ChannelResolver:
    """Per-layer output-channel resolution with pruning overrides.

    Reads a JSON mapping {layer_name: channels} from ``[model] channels``;
    unlisted layers keep their default width.
    """

    def __init__(self, overrides: dict[str, int] | None = None):
        self.overrides = dict(overrides or {})

    @classmethod
    def from_config(cls, config):
        path = config.get("model", "channels", fallback="").strip() if config else ""
        if not path:
            return cls()
        with open(os.path.expanduser(path)) as f:
            return cls(json.load(f))

    def __call__(self, name: str, default: int) -> int:
        return int(self.overrides.get(name, default))


@dataclass
class LayerDef:
    """One conv block in forward (= darknet weight file) order."""

    name: str
    out_ch: int
    ksize: int
    stride: int = 1
    groups: int = 1        # == in_ch for depthwise convs
    bn: bool = True
    act: bool = True
    in_ch: int = 0         # filled in by engine.resolve_in_channels


@dataclass
class ModelBase:
    """Shared config parsing for all model families."""

    anchors: np.ndarray
    num_classes: int
    bn: BNConfig = field(default_factory=BNConfig)
    dtype: torch.dtype = torch.bfloat16
    width: ChannelResolver = field(default_factory=ChannelResolver)
    # kernel selection (``[model] pallas`` tokens); see kernel_active
    pallas: frozenset = frozenset()
    # ``[model] reorg``: "darknet" | "s2d" passthrough channel order (ops/reorg.py)
    reorg_order: str = "darknet"

    @classmethod
    def from_config(cls, config, anchors, num_classes, **kw):
        dtype = torch_dtype(config.get("model", "dtype", fallback="bfloat16"))
        pallas = frozenset(config.get("model", "pallas", fallback="").split())
        reorg_order = config.get("model", "reorg", fallback="darknet")
        return cls(anchors=np.asarray(anchors, np.float32), num_classes=num_classes,
                   bn=BNConfig.from_config(config), dtype=dtype,
                   width=ChannelResolver.from_config(config), pallas=pallas,
                   reorg_order=reorg_order, **kw)

    @property
    def out_channels(self) -> int:
        return len(self.anchors) * (5 + self.num_classes)


def build_model(config, anchors, num_classes):
    """Instantiate the configured backbone class (``[model] dnn`` dotted path,
    resolved to its ``yolojax_torch`` counterpart)."""
    cls = parse_attr(config.get("model", "dnn"))
    return cls.from_config(config, anchors, num_classes)
