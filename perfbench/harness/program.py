"""The system under test, ``yolojax_torch``, through the entry points its
users call: ``entry.flagship`` for the model, ``models/inference.py``'s
``Inference`` (``fold``, ``detect_fn``) for detection, and
``parallel/mesh.py::make_train_step`` with ``utils/train.py::Optimizer`` and
``ops/loss.py::LossConfig`` for training.  Nothing else of the program is
read but its kernels' launch counters."""

from __future__ import annotations

import numpy as np
import torch

from ..reference.yolo import resolve

__all__ = ["build_model", "detect_fn", "train_step", "launch_counters"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _plan_of(model) -> list[dict]:
    """The program's plan in the configuration's terms."""
    out = []
    for op in model.plan:
        if op[0] == "conv":
            d = op[1]
            out.append({"op": "conv", "name": d.name, "out": d.out_ch, "k": d.ksize,
                        "stride": d.stride, "groups": d.groups, "bn": d.bn, "act": d.act,
                        "in": d.in_ch})
        elif op[0] == "pool":
            out.append({"op": "pool", "size": op[1], "stride": op[2]})
        elif op[0] in ("mark", "load", "concat"):
            out.append({"op": op[0], "slot": op[1]})
        elif op[0] == "reorg":
            out.append({"op": "reorg", "stride": op[1]})
    return out


def build_model(cfg: dict):
    """``flagship(backbone=…)`` under the configuration's classes, dtype and
    kernel route; raises where its plan, anchors or BN epsilon are not the
    configuration's."""
    from yolojax_torch.entry import flagship

    model = flagship(num_classes=cfg["num_classes"], dtype=DTYPES[cfg["dtype"]],
                     backbone=cfg["backbone"])
    model.pallas = frozenset(cfg["pallas"])
    want = []
    for op in resolve(cfg["plan"]):
        op = {k: v for k, v in op.items() if k != "depthwise"}
        if op["op"] == "pool":
            op = {"op": "pool", "size": op["size"], "stride": op["stride"]}
        want.append(op)
    if _plan_of(model) != want:
        raise RuntimeError(f"perfbench: the program's {cfg['backbone']} plan is not "
                           f"{cfg['name']}'s")
    if not np.allclose(np.asarray(model.anchors), np.asarray(cfg["anchors"]), rtol=1e-6, atol=0):
        raise RuntimeError(f"perfbench: the program's anchors are not {cfg['name']}'s")
    if model.bn.eps != cfg["bn_eps"] or model.reorg_order != cfg["reorg"]:
        raise RuntimeError(f"perfbench: the program's BN epsilon or reorg order is not "
                           f"{cfg['name']}'s")
    return model


def detect_fn(model, params, state, traffic):
    """(detect, folded): ``Inference(model).detect_fn`` at the traffic's
    threshold, overlap and topk, and the params folded by ``fold``."""
    from yolojax_torch.models.inference import Inference

    inference = Inference(model)
    folded = inference.fold(params, state)
    return inference.detect_fn(traffic["threshold"], traffic["overlap"], traffic["topk"]), folded


def train_step(model, traffic):
    """(step, optimizer): ``make_train_step`` without augmentation, SGD at a
    constant rate with momentum, a global-norm clip and weight decay on
    conv weights, the traffic's loss weights and loss settings."""
    from yolojax_torch.ops.loss import LossConfig
    from yolojax_torch.parallel.mesh import make_train_step
    from yolojax_torch.utils.train import Optimizer

    lr = traffic["lr"]
    optimizer = Optimizer("sgd", schedule=lambda count: lr, clip=traffic["clip"],
                          momentum=traffic["momentum"], weight_decay=traffic["weight_decay"])
    loss = traffic["loss"]
    cfg = LossConfig(ignore_threshold=loss["ignore_threshold"], rescore=True, coord_boost=True,
                     warmup_seen=loss["warmup_seen"], class_grad="darknet")
    return make_train_step(model, optimizer, traffic["loss_weights"], cfg), optimizer


def launch_counters() -> dict:
    """The port's own counts of its hand-written kernels' launches."""
    from yolojax_torch.kernels.dwconv import dwconv3x3
    from yolojax_torch.kernels.dwsep import dwsep
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused

    return {"dwsep": dwsep.launches, "dwconv": dwconv3x3.launches,
            "fusedpost": postprocess_fused.launches}
