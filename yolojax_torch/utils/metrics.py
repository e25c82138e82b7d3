"""Train-loop logging — a copy of ``yolojax/utils/metrics.py`` over dicts of
tensors.

``Summary`` writes per-component scalars, histograms and images through
tensorboardX when it is importable and always mirrors the scalars to a
``scalars.jsonl`` beside the checkpoints, with the JAX package's names.
``Meter`` measures images/s over a sliding window.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np

__all__ = ["Summary", "Meter"]

_LOG = logging.getLogger(__name__)


class Summary:
    def __init__(self, log_dir: str, config=None):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except ImportError:  # tensorboardX is optional
            _LOG.info("tensorboardX unavailable; scalars.jsonl only")
        cfg = {"scalar": 20, "histogram": 2000, "image": 2000}
        if config is not None and config.has_section("summary"):
            for k in cfg:
                cfg[k] = config.getint("summary", k, fallback=cfg[k])
        self.cadence = cfg

    def due(self, kind: str, step: int) -> bool:
        n = self.cadence.get(kind, 0)
        return n > 0 and step % n == 0

    def scalar(self, step: int, **values: float):
        rec = {"step": step, "time": time.time()}
        for name, value in values.items():
            value = float(value)
            rec[name] = value
            if self._tb:
                self._tb.add_scalar(name, value, step)
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def histogram(self, step: int, tree: dict, prefix: str):
        """One histogram per leaf of a ``{layer: {name: tensor}}`` dict,
        named ``prefix + layer/name``."""
        if not self._tb:
            return
        for layer, leaves in tree.items():
            for name, leaf in leaves.items():
                self._tb.add_histogram(f"{prefix}{layer}/{name}",
                                       leaf.detach().float().cpu().numpy().ravel(), step)

    def image(self, step: int, name: str, image: np.ndarray):
        """HWC float [0,1] image."""
        if self._tb:
            self._tb.add_image(name, np.asarray(image).transpose(2, 0, 1), step)

    def close(self):
        self._jsonl.close()
        if self._tb:
            self._tb.close()


class Meter:
    """Throughput meter: images/s over a sliding window; call mark() once per
    step after the device has finished it."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._counts: list[int] = []

    def mark(self, count: int, now: float | None = None):
        self._times.append(time.time() if now is None else now)
        self._counts.append(count)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._counts.pop(0)

    @property
    def rate(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return sum(self._counts[1:]) / dt if dt > 0 else 0.0
