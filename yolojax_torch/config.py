"""Config surface of the port: the yolojax ini files, resolved to torch code.

Loading, overlays and ``-m`` modifications are ``yolojax.config``'s, reused
unchanged (it imports no jax).  What differs is the resolution of dotted
paths: a value naming ``yolojax.`` code resolves to its ``yolojax_torch.``
counterpart, so one ``config.ini`` drives both packages.  A value whose
counterpart is not ported yet raises an error naming it; it never falls back
to the jax module.
"""

from __future__ import annotations

import importlib
from typing import Any

import torch

from yolojax.config import get_canvas, get_model_dir, load_config  # noqa: F401

__all__ = ["parse_attr", "torch_dtype", "load_config", "get_canvas", "get_model_dir"]

_JAX_PREFIX = "yolojax."
_PORT_PREFIX = "yolojax_torch."

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """``[model] dtype`` value → torch dtype."""
    try:
        return _DTYPES[name.strip()]
    except KeyError:
        raise ValueError(f"unsupported [model] dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def parse_attr(path: str) -> Any:
    """Resolve a dotted config path (``pkg.mod.Symbol``) in the port: a
    ``yolojax.`` prefix becomes ``yolojax_torch.``."""
    target = path.strip()
    if target.startswith(_JAX_PREFIX):
        target = _PORT_PREFIX + target[len(_JAX_PREFIX):]
    module_name, _, attr = target.rpartition(".")
    if not module_name:
        raise ValueError(f"cannot resolve bare name {path!r}; need a dotted path")
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        if e.name and (module_name + ".").startswith(e.name + "."):
            raise ModuleNotFoundError(
                f"{module_name} is not ported yet (config value {path!r})",
                name=module_name) from e
        raise
    try:
        return getattr(module, attr)
    except AttributeError:
        raise AttributeError(f"{target} is not ported yet (config value {path!r})") from None
