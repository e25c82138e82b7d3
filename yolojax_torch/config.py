"""Config surface of the port: the yolojax ini files, resolved to torch code.

The same surface as ``yolojax/config.py``, kept here so that the port
imports nothing of the JAX package:

* one root ``config.ini`` holds every knob;
* ``-c extra.ini`` overlays additional files, later files win;
* ``-m section/key=value`` applies ad-hoc modifications (repeatable);
* values that name code are dotted paths, resolved by :func:`parse_attr`;
* :func:`get_cache_dir` / :func:`get_model_dir` / :func:`get_eval_db` key the
  dataset-cache, checkpoint and eval-log paths off the config;
* :func:`config_digest` is a stable digest of chosen sections, for the
  invalidation of artifacts derived from them.

What differs is the resolution of dotted paths: a value naming ``yolojax.``
code (a module, or a name in one) resolves to its ``yolojax_torch.``
counterpart, so one ``config.ini`` drives both packages.  A value whose
counterpart is not ported yet raises an error naming it; it never falls back
to the jax module.
"""

from __future__ import annotations

import configparser
import hashlib
import importlib
import os
import re
from typing import Any, Iterable, Sequence

import torch

__all__ = ["parse_attr", "parse_attr_list", "torch_dtype", "load_config", "modify_config",
           "get_canvas", "get_root_dir", "get_cache_dir", "get_model_dir", "get_eval_db",
           "get_category_path",
           "default_config_path", "add_config_arguments"]

_JAX_PREFIX = "yolojax."
_PORT_PREFIX = "yolojax_torch."

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

_ENV_RE = re.compile(r"\$\{([^}]+)\}")


def _expand(value: str) -> str:
    """Expand ``~`` and ``${ENV}`` references in config values."""
    value = _ENV_RE.sub(lambda m: os.environ.get(m.group(1), ""), value)
    return os.path.expanduser(value)


def default_config_path() -> str:
    """The repo's root ``config.ini``."""
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config.ini")


def load_config(paths: Sequence[str] | str | None = None,
                modify: Iterable[str] = ()) -> configparser.ConfigParser:
    """Load the root config plus overlays (later files win), then apply the
    ``section/key=value`` modifications of ``-m``."""
    config = configparser.ConfigParser(interpolation=None)
    if paths is None:
        paths = [default_config_path()]
    elif isinstance(paths, str):
        paths = [paths]
    for path in paths:
        with open(path) as f:
            config.read_file(f)
    modify_config(config, modify)
    return config


def modify_config(config: configparser.ConfigParser,
                  modify: Iterable[str]) -> configparser.ConfigParser:
    """Apply ``section/key=value`` command-line modifications in order."""
    for cmd in modify:
        try:
            var, value = cmd.split("=", 1)
            section, key = var.split("/", 1)
        except ValueError as e:
            raise ValueError(f"bad -m modification {cmd!r}; expected section/key=value") from e
        if not config.has_section(section):
            config.add_section(section)
        config.set(section, key, value)
    return config


def torch_dtype(name: str) -> torch.dtype:
    """``[model] dtype`` value → torch dtype."""
    try:
        return _DTYPES[name.strip()]
    except KeyError:
        raise ValueError(f"unsupported [model] dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


def parse_attr(path: str) -> Any:
    """Resolve a dotted config path in the port: a module (``pkg.mod``, e.g. a
    dataset module of ``[cache] datasets``) or a name in one
    (``pkg.mod.Symbol``).  A ``yolojax.`` prefix becomes ``yolojax_torch.``."""
    target = path.strip()
    if target.startswith(_JAX_PREFIX):
        target = _PORT_PREFIX + target[len(_JAX_PREFIX):]
    try:  # the whole path may itself be a module
        return importlib.import_module(target)
    except ModuleNotFoundError as e:
        # only a missing ``target`` (or a parent of it) means "not a module";
        # a module that fails on a missing dependency of its own raises
        if not (e.name and (target + ".").startswith(e.name + ".")):
            raise
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


def parse_attr_list(value: str) -> list[Any]:
    """Resolve a whitespace-separated list of dotted paths (transform pipelines)."""
    return [parse_attr(p) for p in value.split()]


def get_root_dir(config: configparser.ConfigParser) -> str:
    """The artifact root, ``[config] root``."""
    return _expand(config.get("config", "root", fallback="~/.yolojax"))


def _category_tag(config: configparser.ConfigParser) -> str:
    return os.path.splitext(os.path.basename(config.get("cache", "category")))[0]


def get_cache_dir(config: configparser.ConfigParser) -> str:
    """Directory holding the pickled dataset caches for the configured
    category: ``<root>/cache/<category>``."""
    return os.path.join(get_root_dir(config), "cache", _category_tag(config))


def get_model_dir(config: configparser.ConfigParser) -> str:
    """Directory holding checkpoints for the configured model, category and
    name: ``<root>/model/<category>/<Model>/<name>``."""
    model = config.get("model", "dnn").strip().rsplit(".", 1)[-1]
    name = config.get("model", "name", fallback="yolojax")
    return os.path.join(get_root_dir(config), "model", _category_tag(config), model, name)


def get_eval_db(config: configparser.ConfigParser) -> str:
    """The eval CLI's log of results, one JSON row per run, beside the
    checkpoints."""
    return os.path.join(get_model_dir(config), "eval.jsonl")


def get_canvas(config: configparser.ConfigParser) -> int:
    """Host decode-canvas edge (``[data] canvas``), derived when unset or
    empty: the largest train input plus the jitter crop margin, rounded up to
    a multiple of 32 and capped at 672."""
    raw = config.get("data", "canvas", fallback="").strip()
    if raw:
        return int(raw)
    hi = config.getint("train", "multi_scale_max", fallback=608)
    jitter = config.getfloat("transform", "jitter", fallback=0.2)
    return min(672, -(-int(hi * (1.0 + jitter)) // 32) * 32)


def get_category_path(config: configparser.ConfigParser) -> str:
    """Absolute path of the category (class names) file, relative paths
    taken from the repo root."""
    path = _expand(config.get("cache", "category"))
    if not os.path.isabs(path):
        path = os.path.join(os.path.dirname(default_config_path()), path)
    return path


def config_digest(config: configparser.ConfigParser, sections: Sequence[str]) -> str:
    """Stable digest of selected sections, for artifact cache invalidation."""
    h = hashlib.sha1()
    for section in sections:
        if config.has_section(section):
            for key, value in sorted(config.items(section)):
                h.update(f"{section}/{key}={value}\n".encode())
    return h.hexdigest()[:12]


def add_config_arguments(parser) -> None:
    """Install the shared ``-c`` / ``-m`` / ``--logging`` flags on an
    argparse parser."""
    parser.add_argument(
        "-c", "--config", nargs="+", default=[default_config_path()],
        help="config ini files, later files override earlier ones",
    )
    # action="extend": repeated -m flags accumulate; default=None, since
    # extend would mutate a list default in place across invocations
    parser.add_argument(
        "-m", "--modify", nargs="+", action="extend", default=None,
        help="ad-hoc config modifications, section/key=value (repeatable)",
    )
    parser.add_argument("--logging", default="INFO", help="logging level")
