"""Checkpoints — counterpart of ``yolojax/utils/checkpoint.py``, from numpy
alone.

A yolojax checkpoint is one ``.npz`` of flattened pytrees: each key is the
tree's name, a colon, and the leaf's ``jax.tree_util`` key path, e.g.
``params:['c1']['w']``; ``__meta__`` holds a JSON blob ({step, seen}).
:func:`save` writes the same format from nested dicts, atomically, and
:class:`Saver` keeps a seconds cadence and a keep-N window.

``params:`` and ``state:`` carry the JAX package's layouts (:func:`to_jax`:
conv weights OIHW → HWIO), so a checkpoint of either package loads in the
other; :func:`from_jax` is the way back.  ``opt:`` holds the port's own
optimizer state, which the JAX package does not read (nor the port its).
"""

from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import torch

__all__ = ["save", "load", "latest", "contains", "Saver", "from_jax", "to_jax"]

_META_KEY = "__meta__"
_PATH_ITEM = re.compile(r"\['([^']*)'\]|\[(\d+)\]|\.(\w+)")


def _key_path(path: str) -> list:
    """``['c1']['w']`` → ["c1", "w"]; a sequence index ``[0]`` becomes 0 and
    an attribute ``.trace`` (an optax state's field) "trace"."""
    items, pos = [], 0
    for m in _PATH_ITEM.finditer(path):
        if m.start() != pos:
            break
        items.append(int(m.group(2)) if m.group(2) is not None else m.group(1) or m.group(3))
        pos = m.end()
    if pos != len(path) or not items:
        raise ValueError(f"unsupported checkpoint key path {path!r}")
    return items


def _flatten(tree, prefix: str, flat: dict) -> None:
    """Nested dicts of tensors, arrays or numbers → ``prefix['k']...`` keys."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}['{k}']", flat)
    elif isinstance(tree, torch.Tensor):
        flat[prefix] = tree.detach().cpu().numpy()
    else:
        flat[prefix] = np.asarray(tree)


def save(path: str, trees: dict, meta: dict | None = None) -> None:
    """Save named trees (nested dicts) + JSON-serializable meta to one .npz,
    replacing ``path`` atomically: a crash never leaves a torn checkpoint."""
    flat: dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        _flatten(tree, name + ":", flat)
    flat[_META_KEY] = np.frombuffer(json.dumps(meta or {}).encode(), np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load(path: str, names=None) -> tuple[dict, dict]:
    """Read a yolojax ``.npz`` → ({tree name: nested dict of numpy arrays},
    meta), for the trees ``names`` (all by default)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop(_META_KEY)).decode()) if _META_KEY in flat else {}
    trees: dict = {}
    for key, arr in flat.items():
        name, sep, rest = key.partition(":")
        if not sep:
            raise ValueError(f"checkpoint key {key!r} has no tree name")
        if names is not None and name not in names:
            continue
        node = trees.setdefault(name, {})
        *parents, leaf = _key_path(rest)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return trees, meta


def contains(path: str, name: str) -> bool:
    """Whether a checkpoint holds any keys of the named tree (a converted
    darknet ``0.npz`` has params and state but no ``opt:``)."""
    with np.load(path) as z:
        return any(k.startswith(name + ":") for k in z.files)


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


def to_jax(params: dict, state: dict) -> tuple[dict, dict]:
    """The port's (params, state) → the JAX package's numpy layouts: conv
    weights ``w`` OIHW → HWIO (``transpose(2, 3, 1, 0)``, the inverse of
    :func:`from_jax`), every other leaf as it is."""
    def convert(tree, is_params):
        return {layer: {name: (v.detach().cpu().numpy().transpose(2, 3, 1, 0)
                               if is_params and name == "w" else v.detach().cpu().numpy())
                        for name, v in leaves.items()}
                for layer, leaves in tree.items()}

    return convert(params, True), convert(state, False)


class Saver:
    """Seconds-cadence checkpointing to ``<model_dir>/<step>.npz`` with a
    keep-N window."""

    def __init__(self, model_dir: str, interval: float = 600.0, keep: int = 5):
        self.model_dir = model_dir
        self.interval = interval
        self.keep = keep
        self._last = None
        os.makedirs(model_dir, exist_ok=True)

    def due(self, now: float) -> bool:
        """The first call arms the timer; later ones say whether
        ``interval`` seconds have passed since the last save."""
        if self._last is None:
            self._last = now
            return False
        return now - self._last >= self.interval

    def __call__(self, now: float, step: int, trees: dict, meta: dict) -> str:
        self._last = now
        path = os.path.join(self.model_dir, f"{step}.npz")
        save(path, trees, meta)
        self._prune()
        return path

    def _prune(self) -> None:
        paths = sorted(
            ((int(os.path.basename(p)[:-4]), p)
             for p in glob.glob(os.path.join(self.model_dir, "*.npz"))
             if os.path.basename(p)[:-4].isdigit()))
        for _, p in paths[:-self.keep] if self.keep else []:
            os.remove(p)
