"""Category (class name) lists and anchor tables (counterpart of
``yolojax/category.py``).

* class lists are plain text, one name per line;
* anchors are a tsv of ``(height, width)`` pairs in grid-cell units (416
  input / 32 stride = a 13-cell grid): the darknet cfg values yx-swapped.
"""

from __future__ import annotations

import os

import numpy as np

from . import config as _config

__all__ = ["get_category", "get_anchors", "load_category_file", "load_anchors_file"]


def load_category_file(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def load_anchors_file(path: str) -> np.ndarray:
    """Load an anchors tsv → float32 array of shape (A, 2) in (h, w) order."""
    anchors = np.loadtxt(path, dtype=np.float32, ndmin=2)
    if anchors.shape[1] != 2:
        raise ValueError(f"anchors file {path}: expected 2 columns (h, w), got {anchors.shape[1]}")
    return anchors


def get_category(config) -> list[str]:
    """Class names for the configured dataset (``[cache] category``)."""
    return load_category_file(_config.get_category_path(config))


def get_anchors(config) -> np.ndarray:
    """Anchor (h, w) pairs in grid units for the configured model
    (``[model] anchors``, relative paths taken from the repo root)."""
    path = os.path.expanduser(config.get("model", "anchors"))
    if not os.path.isabs(path):
        path = os.path.join(os.path.dirname(_config.default_config_path()), path)
    return load_anchors_file(path)
