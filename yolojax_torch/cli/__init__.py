"""CLI entry points of the port (``python -m yolojax_torch.cli.detect``).

Every command takes ``-c config.ini [more.ini …]`` overlays and ``-m
section/key=value`` modifications, as ``yolojax/cli/__init__.py``'s do.
"""

from __future__ import annotations

import argparse
import logging

from ..config import add_config_arguments, load_config

__all__ = ["make_parser", "setup"]


def make_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    add_config_arguments(parser)
    return parser


def setup(args):
    """Configure logging from ``--logging`` and load the config of ``-c`` /
    ``-m``."""
    logging.basicConfig(
        level=getattr(logging, str(args.logging).upper(), logging.INFO),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    return load_config(args.config, args.modify or ())
