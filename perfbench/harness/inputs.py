"""The benchmark's inputs, made on the device from ``--seed``: parameters and
BN state in the port's layout (f32 masters; the program folds and casts
them), frames, and train batches with their boxes.  Each comes from its own
``torch.Generator`` on the device, seeded from ``--seed`` and a tag, in a
few large calls."""

from __future__ import annotations

import zlib

import numpy as np
import torch

import torch.nn.functional as F

from ..reference.yolo import conv_layers, float32_exact, leaky, run

__all__ = ["sub_seed", "generator", "make_params", "make_frames", "make_boxes"]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed`` (any whole
    number, however large)."""
    seq = np.random.SeedSequence([int(seed) % (1 << 64), int(seed) >> 64, zlib.crc32(tag.encode())])
    return int(seq.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return gen


def make_params(cfg: dict, seed: int, device):
    """(params, state): He-normal OIHW conv weights from one draw, the head's
    rows for each anchor's centre, size, objectness and classes scaled by
    ``init["head_gain"]``; BN scale and shift uniform in the configuration's
    ranges; the head's bias zero but for each anchor's objectness, which is
    ``objectness_logit`` shifted by the one offset that gives the stats
    frames' scores the bench density (:func:`_density_offset`).  The BN
    running statistics are those of the data, as a trained network's are:
    each layer's mean and variance over ``init["stats_frames"]`` seeded frames,
    taken in plan order on the inference forward of the layers before it,
    the variance times a factor uniform in ``init["bn_var"]`` (a running
    average never matches the data exactly)."""
    gen = generator(seed, "params", device)
    layers = conv_layers(cfg["plan"])
    sizes = [op["out"] * (op["in"] // op["groups"]) * op["k"] ** 2 for op in layers]
    fan_in = torch.tensor([(op["in"] // op["groups"]) * op["k"] ** 2 for op in layers],
                          dtype=torch.float32, device=device)
    gain = torch.repeat_interleave(torch.sqrt(2.0 / fan_in),
                                   torch.tensor(sizes, device=device))
    flat = torch.randn(sum(sizes), generator=gen, device=device) * gain
    bn = [op for op in layers if op["bn"]]
    n_bn = sum(op["out"] for op in bn)
    init = cfg["init"]
    lo_hi = torch.tensor([init[k] for k in ("bn_gamma", "bn_beta", "bn_var")],
                         dtype=torch.float32, device=device)
    u = torch.rand((3, n_bn), generator=gen, device=device)
    bn_vals = lo_hi[:, :1] + (lo_hi[:, 1:] - lo_hi[:, :1]) * u
    params, var_factor = {}, {}
    at = at_bn = 0
    for op, n in zip(layers, sizes):
        w = flat[at:at + n].view(op["out"], op["in"] // op["groups"], op["k"], op["k"])
        at += n
        if op["bn"]:
            o = slice(at_bn, at_bn + op["out"])
            at_bn += op["out"]
            params[op["name"]] = {"w": w, "gamma": bn_vals[0, o], "beta": bn_vals[1, o]}
            var_factor[op["name"]] = bn_vals[2, o]
        else:
            per = 5 + cfg["num_classes"]
            head = init["head_gain"]
            rows = torch.tensor([head["yx"]] * 2 + [head["hw"]] * 2 + [head["obj"]]
                                + [head["cls"]] * cfg["num_classes"], device=device)
            w.mul_(rows.repeat(op["out"] // per)[:, None, None, None])
            b = torch.zeros(op["out"], device=device)
            b.view(-1, per)[:, 4] = cfg["objectness_logit"]
            params[op["name"]] = {"w": w, "b": b}
    frames = make_frames(init["stats_frames"], cfg["size"], seed, device, tag="bn_stats")
    state = {}

    def block(op, x):
        p = params[op["name"]]
        y = F.conv2d(x, p["w"], stride=op["stride"], padding=op["k"] // 2, groups=op["groups"])
        if not op["bn"]:
            return y + p["b"].view(1, -1, 1, 1)
        var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
        var = var * var_factor[op["name"]]
        state[op["name"]] = {"mean": mean, "var": var}
        y = (y - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + cfg["bn_eps"]).view(1, -1, 1, 1)
        return leaky(y * p["gamma"].view(1, -1, 1, 1) + p["beta"].view(1, -1, 1, 1))

    with float32_exact(), torch.no_grad():
        raw = run(cfg["plan"], frames, block)
        head = params[layers[-1]["name"]]["b"]
        head.view(-1, 5 + cfg["num_classes"])[:, 4] += _density_offset(cfg, raw)
    return params, state


def _density_offset(cfg: dict, raw) -> float:
    """The one shift of every anchor's objectness logit after which a share
    ``init["density"]`` of the (cell, class) scores of ``raw`` (the head on
    the stats frames) clears ``init["density_threshold"]``: bisection, the
    share rising with the shift."""
    init, per = cfg["init"], 5 + cfg["num_classes"]
    x = raw.reshape(*raw.shape[:-1], -1, per)
    prob = torch.softmax(x[..., 5:], dim=-1)
    share = lambda shift: float((torch.sigmoid(x[..., 4:5] + shift) * prob
                                 > init["density_threshold"]).float().mean())
    lo, hi = -30.0, 30.0
    for _ in range(40):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if share(mid) < init["density"] else (lo, mid)
    return (lo + hi) / 2


def make_frames(n: int, size: int, seed: int, device, tag: str = "frames") -> torch.Tensor:
    """``n`` NHWC f32 frames of uniform noise in [0, 1)."""
    gen = generator(seed, tag, device)
    return torch.rand((n, size, size, 3), generator=gen, device=device)


def make_boxes(n: int, boxes: int, classes: int, seed: int, device) -> dict:
    """Ground truth of ``n`` images, ``boxes`` each: centres uniform in
    [0.2, 0.8], half sizes in [0.02, 0.3], clipped to the image; classes
    uniform; all valid."""
    gen = generator(seed, "boxes", device)
    center = 0.2 + 0.6 * torch.rand((n, boxes, 2), generator=gen, device=device)
    half = 0.02 + 0.28 * torch.rand((n, boxes, 2), generator=gen, device=device)
    cls = torch.randint(0, classes, (n, boxes), generator=gen, device=device, dtype=torch.int32)
    return {"yx_min": torch.clamp(center - half, 0, 1), "yx_max": torch.clamp(center + half, 0, 1),
            "cls": cls, "valid": torch.ones((n, boxes), dtype=torch.bool, device=device)}
