"""Dataset record cache — a copy of ``yolojax/data/cache.py``.

A cache is one pickled list of records per phase::

    {"path": str, "yx_min": (N,2) f32, "yx_max": (N,2) f32,
     "cls": (N,) i32, "difficult": (N,) bool}

with boxes normalized to [0, 1] in yx order, under :func:`cache_path`.
:func:`cache` builds it once from the dataset modules of ``[cache]
datasets`` (dotted paths, e.g. ``yolojax.data.voc``, which resolves to
``yolojax_torch.data.voc``); each module has ``load(config, phase, category)
-> list[record]``.  Train and eval read only the pickle, and either package
reads the other's.
"""

from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from .. import config as _config
from ..category import get_category

__all__ = ["cache", "load_cache", "cache_path", "make_record", "PHASES"]

PHASES = ("train", "val", "test")
_LOG = logging.getLogger(__name__)


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


def cache(config, phases=PHASES) -> dict[str, list[dict]]:
    """Build and write the per-phase record caches of every configured
    dataset module; returns the records by phase."""
    modules = _config.parse_attr_list(config.get("cache", "datasets"))
    category = get_category(config)
    os.makedirs(_config.get_cache_dir(config), exist_ok=True)
    out = {}
    for phase in phases:
        records: list[dict] = []
        for module in modules:
            got = module.load(config, phase, category)
            _LOG.info("%s: %s → %d images", phase, module.__name__, len(got))
            records.extend(got)
        with open(cache_path(config, phase), "wb") as f:
            pickle.dump(records, f, protocol=pickle.HIGHEST_PROTOCOL)
        out[phase] = records
    return out


def load_cache(config, phase: str) -> list[dict]:
    """The records of ``phase``.  The pickle is one this project wrote (the
    cache builder); unpickle no file of another origin."""
    path = cache_path(config, phase)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no dataset cache at {path}; run `python -m yolojax_torch.cli.cache` "
            "(or the JAX package's `python cache.py`) first")
    with open(path, "rb") as f:
        return pickle.load(f)
