"""Device-resident dataset — counterpart of ``yolojax/data/device_cache.py``.

Where the decoded dataset fits on the card (canvases are uint8: 600 images
at 672² are about 0.8 GB), every canvas and padded label array is uploaded
once, and each train batch is gathered on the device by index: a step ships
its indices, not its pixels, and the loader's threads and host-to-device
copies leave the hot loop.  Enable with ``[data] device_dataset = 1`` (off
by default: real VOC or COCO does not fit).

The epochs are the :class:`~.loader.Loader`'s: ``np.random.default_rng(seed)``
shuffles ``arange(n)`` each epoch and the global batch (``batch_size ·
count``) drops the last partial one.  With ``shard=(index, count)`` (rank
``index`` of ``count``) every rank draws the same global index batches,
holds a full copy of the arrays, and gathers its own rows ``[index·b,
(index+1)·b)`` of each, which are the rows the JAX package's
``batch_sharding`` of its global gather hands that process.
"""

from __future__ import annotations

import numpy as np
import torch

from .dataset import collate

__all__ = ["DeviceDataset", "KEYS"]

# the batch the train step takes (parallel/mesh.py make_train_step)
KEYS = ("canvas", "hw", "yx_min", "yx_max", "cls", "valid")
CHUNK_BYTES = 64 << 20


def _upload(v: np.ndarray, device) -> torch.Tensor:
    """``v`` on ``device``, sent as its uint8 bytes in copies of at most
    ``CHUNK_BYTES`` into one buffer, then viewed as its dtype and shape."""
    raw = np.ascontiguousarray(v).reshape(-1).view(np.uint8)
    out = torch.empty(raw.size, dtype=torch.uint8, device=device)
    for i in range(0, raw.size, CHUNK_BYTES):
        out[i:i + CHUNK_BYTES].copy_(torch.from_numpy(raw[i:i + CHUNK_BYTES]))
    return out.view(torch.from_numpy(v[:0]).dtype).view(v.shape)


class DeviceDataset:
    """The whole dataset's ``KEYS`` arrays on ``device`` and an on-device row
    gather; iterating yields this rank's train batches forever."""

    def __init__(self, dataset, device, batch_size: int, *, seed: int = 0,
                 shard: tuple[int, int] = (0, 1)):
        n = len(dataset)
        if n == 0:
            raise ValueError("device dataset: empty dataset")
        host = collate([{k: item[k] for k in KEYS} for item in map(dataset.load, range(n))])
        self.arrays = {k: _upload(v, device) for k, v in host.items()}
        self.nbytes = sum(v.nbytes for v in host.values())
        self.n = n
        self.device = torch.device(device)
        self.batch_size = batch_size
        self.shard = shard
        self.global_batch = batch_size * shard[1]
        self.rng = np.random.default_rng(seed)

    def gather(self, indices) -> dict:
        """The rows ``indices`` of every array, on the device; out-of-range
        indices are clamped, as JAX's ``take(mode="clip")``."""
        idx = torch.as_tensor(np.asarray(indices, np.int64)).clamp_(0, self.n - 1)
        idx = idx.to(self.device)
        return {k: v.index_select(0, idx) for k, v in self.arrays.items()}

    def _epochs(self):
        b = self.global_batch
        while True:
            order = np.arange(self.n)
            self.rng.shuffle(order)
            for i in range(0, len(order) - b + 1, b):
                yield order[i:i + b]

    def __iter__(self):
        index = self.shard[0] * self.batch_size
        for idx in self._epochs():
            yield self.gather(idx[index:index + self.batch_size])
