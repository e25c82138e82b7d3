"""A sample of a window's calls, drawn from the run's seed."""

from __future__ import annotations

import numpy as np

from .inputs import sub_seed

__all__ = ["Reservoir"]


class Reservoir:
    """``k`` items of a stream whose length is not known ahead, each item
    kept with the same chance (reservoir sampling), the draws from ``seed``."""

    def __init__(self, k: int, seed: int, tag: str = "sample"):
        self.k, self.items, self.offered = k, [], 0
        self._rng = np.random.default_rng(sub_seed(seed, tag))

    def offer(self, item) -> None:
        self.offered += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self._rng.integers(self.offered))
        if j < self.k:
            self.items[j] = item
