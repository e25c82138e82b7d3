"""Shared CLI plumbing of the port: model construction and weight resolution
(counterpart of ``yolojax/cli/common.py``)."""

from __future__ import annotations

import logging

import torch

from ..category import get_anchors, get_category
from ..config import get_model_dir
from ..models import build_model
from ..utils import checkpoint as ckpt

_LOG = logging.getLogger(__name__)


def build(config):
    """(category, anchors, model) from the ini spec."""
    category = get_category(config)
    anchors = get_anchors(config)
    model = build_model(config, anchors, len(category))
    return category, anchors, model


def load_weights_auto(config, model, path: str | None = None, resume: bool = False,
                      rng_seed: int = 0, reinit_head: bool = False, device="cpu"):
    """Resolve (params, state, meta) on ``device``, as the JAX package's
    train and eval do: an explicit ``path`` (npz checkpoint or darknet
    ``.weights``) > ``resume`` from the newest npz in the model dir > a fresh
    init drawn from ``torch.Generator`` seeded with ``rng_seed``.
    ``reinit_head`` keeps a fresh head where a ``.weights`` file's head was
    trained for another class count (finetuning)."""
    if path is not None and path.endswith(".weights"):
        from ..tools.darknet import load_weights

        params, state, seen = load_weights(path, model, reinit_head_on_mismatch=reinit_head,
                                           head_rng_seed=rng_seed, device=device)
        _LOG.info("imported darknet weights %s (seen=%d)", path, seen)
        return params, state, {"seen": seen}
    params, state = model.init(torch.Generator().manual_seed(rng_seed), device)
    if path is None and resume:
        path = ckpt.latest(get_model_dir(config))
        if path is None:
            _LOG.info("no checkpoint to resume; fresh init")
    if path is None:
        return params, state, {}
    trees, meta = ckpt.load(path, ("params", "state"))
    loaded = ckpt.from_jax(trees.get("params", {}), trees.get("state", {}), device)
    for fresh, got, tree in zip((params, state), loaded, ("params", "state")):
        for layer, leaves in fresh.items():
            for name, v in leaves.items():
                key = f"{tree}:['{layer}']['{name}']"
                if name not in got.get(layer, {}):
                    raise KeyError(f"checkpoint missing {key!r}")
                if got[layer][name].shape != v.shape:
                    raise ValueError(f"checkpoint {key!r} shape "
                                     f"{tuple(got[layer][name].shape)} != model {tuple(v.shape)}")
    _LOG.info("loaded checkpoint %s (step=%s)", path, meta.get("step"))
    return loaded[0], loaded[1], meta
