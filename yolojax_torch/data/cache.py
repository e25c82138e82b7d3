"""Dataset record cache — the read side of ``yolojax/data/cache.py``.

A cache is one pickled list of records per phase::

    {"path": str, "yx_min": (N,2) f32, "yx_max": (N,2) f32,
     "cls": (N,) i32, "difficult": (N,) bool}

with boxes normalized to [0, 1] in yx order.  ``python cache.py`` (the JAX
package's builder) writes it under :func:`cache_path`; the port reads the
same file.  Building a cache — the VOC and COCO parsers behind ``[cache]
datasets`` — is not ported yet: ``yolojax.data.cache.cache`` resolves to
nothing here, and the config error names it.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from .. import config as _config

__all__ = ["load_cache", "cache_path", "make_record", "PHASES"]

PHASES = ("train", "val", "test")


def make_record(path: str, yx_min, yx_max, cls, difficult=None) -> dict:
    """Normalize a parsed annotation into the canonical record schema."""
    yx_min = np.asarray(yx_min, np.float32).reshape(-1, 2)
    yx_max = np.asarray(yx_max, np.float32).reshape(-1, 2)
    cls = np.asarray(cls, np.int32).reshape(-1)
    if difficult is None:
        difficult = np.zeros(len(cls), bool)
    return {
        "path": path,
        "yx_min": yx_min,
        "yx_max": yx_max,
        "cls": cls,
        "difficult": np.asarray(difficult, bool).reshape(-1),
    }


def cache_path(config, phase: str) -> str:
    return os.path.join(_config.get_cache_dir(config), f"{phase}.pkl")


def load_cache(config, phase: str) -> list[dict]:
    """The records of ``phase``.  The pickle is one this project wrote (the
    cache builder); unpickle no file of another origin."""
    path = cache_path(config, phase)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no dataset cache at {path}; run `python cache.py` first")
    with open(path, "rb") as f:
        return pickle.load(f)
