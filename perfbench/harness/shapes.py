"""Work counted from a configuration's layer shapes: conv MACs and FLOPs per
image, parameters, and the operations and bytes of the layers that the
port's depthwise kernels take, for their rooflines.

A roofline's bytes count each input once (activations, taps, weights,
biases) and each output once, in the stored dtypes: bf16 activations and
weights, f32 biases."""

from __future__ import annotations

from ..reference.yolo import resolve

__all__ = ["conv_shapes", "forward_macs", "forward_flops", "param_count", "routed_layers",
           "kernel_work", "DWSEP_MAX_H", "DWSEP_MAX_CHANNELS"]

# the port's routing gates for its depthwise kernels (models/engine.py):
# channels a multiple of 128; a dwsep pair needs an input height <= 40 and,
# in bf16, at most 1024 channels
DWSEP_MAX_H = 40
DWSEP_MAX_CHANNELS = 1024
ACT_BYTES, BIAS_BYTES = 2, 4


def conv_shapes(plan, size: int) -> list[dict]:
    """Each conv of the plan at a square input ``size``: its op with ``h``,
    ``w`` (input) and ``ho``, ``wo`` (output) added."""
    h = w = size
    slots, out = {}, []
    for op in resolve(plan):
        kind = op["op"]
        if kind == "conv":
            s = op["stride"]
            ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
            out.append(dict(op, h=h, w=w, ho=ho, wo=wo))
            h, w = ho, wo
        elif kind == "pool":
            h, w = h // op["stride"], w // op["stride"]
        elif kind == "mark":
            slots[op["slot"]] = (h, w)
        elif kind == "load":
            h, w = slots[op["slot"]]
        elif kind == "reorg":
            h, w = h // op["stride"], w // op["stride"]
    return out


def _macs(c: dict) -> int:
    return c["ho"] * c["wo"] * c["out"] * (c["in"] // c["groups"]) * c["k"] * c["k"]


def forward_macs(plan, size: int) -> int:
    """Multiply-adds of every conv of one image's forward."""
    return sum(_macs(c) for c in conv_shapes(plan, size))


def forward_flops(plan, size: int) -> int:
    return 2 * forward_macs(plan, size)


def param_count(plan) -> int:
    total = 0
    for c in conv_shapes(plan, 32):
        total += c["out"] * (c["in"] // c["groups"]) * c["k"] ** 2
        total += 2 * c["out"] if c["bn"] else c["out"]
    return total


def _dw_routable(c: dict) -> bool:
    return c["groups"] > 1 and c["k"] == 3 and c["in"] % 128 == 0


def routed_layers(plan, size: int, pallas) -> dict:
    """{"dwsep": [(dw, pw), ...], "dwconv": [dw, ...]}: the layers the port's
    depthwise kernels take under the ``pallas`` tokens, by the port's gates."""
    convs = conv_shapes(plan, size)
    out = {"dwsep": [], "dwconv": []}
    i = 0
    while i < len(convs):
        c = convs[i]
        nxt = convs[i + 1] if i + 1 < len(convs) else None
        pair = ("dwsep" in pallas and _dw_routable(c) and c["act"] and c["h"] <= DWSEP_MAX_H
                and c["in"] <= DWSEP_MAX_CHANNELS and nxt is not None and nxt["k"] == 1
                and nxt["groups"] == 1 and nxt["act"])
        if pair:
            out["dwsep"].append((c, nxt))
            i += 2
            continue
        if "dwconv" in pallas and _dw_routable(c):
            out["dwconv"].append(c)
        i += 1
    return out


def _act(c: dict, which: str) -> int:
    return (c["h"] * c["w"] * c["in"]) if which == "in" else (c["ho"] * c["wo"] * c["out"])


def kernel_work(plan, size: int, pallas, batch: int) -> dict:
    """{"dwsep": (flops, bytes), "dwconv": (flops, bytes)} of one call at
    ``batch`` images: the routed layers' convs, their inputs read once and
    outputs written once."""
    routed = routed_layers(plan, size, pallas)
    flops = bytes_ = 0
    for dw, pw in routed["dwsep"]:
        flops += 2 * batch * (_macs(dw) + _macs(pw))
        bytes_ += ACT_BYTES * (batch * _act(dw, "in") + 9 * dw["in"] + pw["in"] * pw["out"]
                               + batch * _act(pw, "out"))
        bytes_ += BIAS_BYTES * (dw["out"] + pw["out"])
    work = {"dwsep": (flops, bytes_)}
    flops = bytes_ = 0
    for dw in routed["dwconv"]:
        flops += 2 * batch * _macs(dw)
        bytes_ += ACT_BYTES * (batch * (_act(dw, "in") + _act(dw, "out")) + 9 * dw["in"])
        bytes_ += BIAS_BYTES * dw["out"]
    work["dwconv"] = (flops, bytes_)
    return work
