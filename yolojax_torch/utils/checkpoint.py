"""Checkpoint loading — the read side of ``yolojax/utils/checkpoint.py``,
from numpy alone.

A yolojax checkpoint is one ``.npz`` of flattened pytrees: each key is the
tree's name, a colon, and the leaf's ``jax.tree_util`` key path, e.g.
``params:['c1']['w']``; ``__meta__`` holds a JSON blob.  :func:`from_jax`
turns the JAX package's numpy parameter dicts into the port's tensors
(conv weights HWIO → OIHW).
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import torch

__all__ = ["load", "latest", "from_jax"]

_META_KEY = "__meta__"
_PATH_ITEM = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _key_path(path: str) -> list:
    """``['c1']['w']`` → ["c1", "w"]."""
    items, pos = [], 0
    for m in _PATH_ITEM.finditer(path):
        if m.start() != pos:
            break
        items.append(m.group(1) if m.group(1) is not None else int(m.group(2)))
        pos = m.end()
    if pos != len(path) or not items:
        raise ValueError(f"unsupported checkpoint key path {path!r}")
    return items


def load(path: str) -> tuple[dict, dict]:
    """Read a yolojax ``.npz`` → ({tree name: nested dict of numpy arrays}, meta)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop(_META_KEY)).decode()) if _META_KEY in flat else {}
    trees: dict = {}
    for key, arr in flat.items():
        name, sep, rest = key.partition(":")
        if not sep:
            raise ValueError(f"checkpoint key {key!r} has no tree name")
        node = trees.setdefault(name, {})
        *parents, leaf = _key_path(rest)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return trees, meta


def latest(model_dir: str) -> str | None:
    """Newest step checkpoint in a model dir (``<step>.npz``)."""
    paths = glob.glob(os.path.join(model_dir, "*.npz"))
    steps = [(int(m.group(1)), p) for p in paths
             if (m := re.fullmatch(r"(\d+)\.npz", os.path.basename(p)))]
    return max(steps)[1] if steps else None


def from_jax(params: dict, state: dict, device="cpu") -> tuple[dict, dict]:
    """JAX-layout numpy (params, state) → the port's f32 tensors.

    Conv weights ``w`` go from HWIO to OIHW (``transpose(3, 2, 0, 1)``);
    every other leaf keeps its shape.
    """
    def convert(tree, is_params):
        out = {}
        for layer, leaves in tree.items():
            out[layer] = {}
            for name, v in leaves.items():
                v = np.asarray(v, np.float32)
                if is_params and name == "w":
                    v = v.transpose(3, 2, 0, 1)
                out[layer][name] = torch.tensor(v, device=device)
        return out

    return convert(params, True), convert(state, False)
