"""Darknet ``.weights`` import and export — counterpart of
``yolojax/tools/darknet.py``.

File format (as darknet writes it):

* header: int32 ``major, minor, revision`` then ``seen`` — uint32 when
  ``major*10 + minor < 2``, uint64 otherwise;
* per conv layer, in cfg order (``model.layer_defs``): with BN —
  ``beta[n] gamma[n] mean[n] var[n]`` then the conv weights; without BN —
  ``bias[n]`` then the conv weights; weights are float32 in OIHW order.

The port keeps conv weights in OIHW, so they load without a transpose (the
JAX package transposes them to HWIO).  As there, the head conv's output
channels are permuted at import: darknet's region layer reads per-anchor
fields ``[tx, ty, tw, th, to, cls…]``, and the decode contract is yx-order
``[ty, tx, th, tw, to, cls…]``.  The permutation is an involution, so export
applies the same one.  The reader requires the file to be consumed exactly to
its end.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.darknet import init_layer

__all__ = ["load_weights", "save_weights", "head_permutation"]

_HEADER_VERSION = (0, 2, 0)


def head_permutation(num_anchors: int, num_classes: int) -> np.ndarray:
    """Output-channel permutation mapping darknet xy/wh field order to yx.

    For each anchor block of size 5+C: [1, 0, 3, 2, 4, 5, …] — swap (tx,ty)
    and (tw,th). Involution: the same permutation converts both directions.
    """
    per = 5 + num_classes
    block = np.arange(per)
    block[[0, 1, 2, 3]] = [1, 0, 3, 2]
    return np.concatenate([a * per + block for a in range(num_anchors)])


class _Reader:
    def __init__(self, path: str):
        self.buf = np.fromfile(path, dtype=np.uint8)
        self.pos = 0
        self.size = self.buf.size

    def take(self, count: int, dtype) -> np.ndarray:
        nbytes = count * np.dtype(dtype).itemsize
        if self.pos + nbytes > self.size:
            raise ValueError(
                f"darknet weights truncated: need {nbytes} bytes at offset "
                f"{self.pos}, file has {self.size}")
        out = self.buf[self.pos:self.pos + nbytes].view(dtype)
        self.pos += nbytes
        return out.copy()


def load_weights(path: str, model, reinit_head_on_mismatch: bool = False,
                 head_rng_seed: int = 0, device="cpu"):
    """Read a darknet ``.weights`` file into (params, state, seen) for
    ``model``, tensors on ``device``; ``seen`` feeds the loss warmup.

    ``reinit_head_on_mismatch`` is the finetune behaviour: when the file's
    last conv was trained for another class count, its bytes are read and
    dropped, and the model keeps a fresh head drawn by :func:`init_layer`
    from a ``torch.Generator`` seeded with ``head_rng_seed``.
    """
    r = _Reader(os.path.expanduser(path))
    major, minor, _rev = (int(v) for v in r.take(3, np.int32))
    seen = int(r.take(1, np.uint64 if major * 10 + minor >= 2 else np.uint32)[0])

    params, state = {}, {}
    defs = model.layer_defs
    perm = torch.from_numpy(head_permutation(len(model.anchors), model.num_classes))
    f32 = lambda n: torch.from_numpy(r.take(n, np.float32))
    for d in defs:
        n, fan_in = d.out_ch, (d.in_ch // d.groups) * d.ksize * d.ksize
        if d is defs[-1] and reinit_head_on_mismatch and not d.bn:
            remaining = r.size - r.pos
            if remaining != (n + n * fan_in) * 4:
                # the head of another class count: the rest must parse as
                # bias + weights of SOME channel count; drop it, draw a fresh head
                per_out = (1 + fan_in) * 4
                if remaining % per_out:
                    raise ValueError(
                        f"darknet head mismatch: {remaining} trailing bytes "
                        f"do not parse as a {d.ksize}x{d.ksize} conv over "
                        f"{d.in_ch} inputs")
                r.take(remaining // 4, np.float32)
                params[d.name], _ = init_layer(
                    d, torch.Generator().manual_seed(head_rng_seed))
                continue
        p: dict = {}
        if d.bn:
            p["beta"], p["gamma"] = f32(n), f32(n)
            state[d.name] = {"mean": f32(n), "var": f32(n)}
        else:
            p["b"] = f32(n)
        p["w"] = f32(n * fan_in).reshape(n, d.in_ch // d.groups, d.ksize, d.ksize)
        # the head: bake the xy→yx field swap into its output channels, only
        # where the channel count is the detection head's (a classification
        # trunk imports unchanged)
        if d is defs[-1] and n == perm.numel():
            p["w"] = p["w"][perm]
            if "b" in p:
                p["b"] = p["b"][perm]
        params[d.name] = p

    if r.pos != r.size:
        raise ValueError(
            f"darknet weights not fully consumed: {r.size - r.pos} bytes left "
            f"(model/file layer mismatch?)")
    move = lambda tree: {k: {m: v.to(device) for m, v in lp.items()} for k, lp in tree.items()}
    return move(params), move(state), seen


def save_weights(path: str, model, params, state, seen: int = 0):
    """Write (params, state), OIHW tensors on any device, to darknet
    ``.weights`` format."""
    chunks = [np.asarray(_HEADER_VERSION, np.int32).view(np.uint8)]
    major, minor, _ = _HEADER_VERSION
    seen_dtype = np.uint64 if major * 10 + minor >= 2 else np.uint32
    chunks.append(np.asarray([seen], seen_dtype).view(np.uint8))

    host = lambda t: t.detach().to("cpu", torch.float32).numpy()
    defs = model.layer_defs
    perm = head_permutation(len(model.anchors), model.num_classes)
    for d in defs:
        p = {k: host(v) for k, v in params[d.name].items()}
        if d is defs[-1] and d.out_ch == perm.size:
            p["w"] = p["w"][perm]
            if "b" in p:
                p["b"] = p["b"][perm]
        if d.bn:
            s = state[d.name]
            arrays = (p["beta"], p["gamma"], host(s["mean"]), host(s["var"]))
        else:
            arrays = (p["b"],)
        chunks.extend(np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                      for a in (*arrays, p["w"]))
    np.concatenate(chunks).tofile(os.path.expanduser(path))
