"""Background-thread batch loader — counterpart of ``yolojax/data/loader.py``.

:class:`Loader` is the JAX package's: a thread pool decodes (cv2 releases
the GIL) and collates shuffled batches into a bounded queue; the shuffle
draws from ``np.random.default_rng(seed)``, so a seed gives the JAX loader's
batch order, and ``shard=(index, count)`` gives node ``index`` of ``count``
its disjoint share of every epoch, as the JAX loader gives each process;
``part=(index, count)`` then gives each of the node's ranks its contiguous
rows of every node batch, as the JAX process splits its batch over its
chips.
The batches are size-agnostic host canvases; the train loop picks each
step's input size and runs the augmentation on the device.

:func:`overlap_device_puts` copies upcoming batches to the device from a
side thread, so batch k+1's copy rides while step k computes: pinned host
memory, ``non_blocking`` copies on a side CUDA stream, and an event that the
consumer's stream waits on before it touches the batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .dataset import collate

__all__ = ["Loader", "overlap_device_puts"]


class Loader:
    """Iterates shuffled, collated host batches forever (or one epoch)."""

    def __init__(self, dataset, batch_size: int, *, workers: int = 3, seed: int = 0,
                 shuffle: bool = True, drop_last: bool = True, depth: int = 3,
                 shard: tuple[int, int] = (0, 1), part: tuple[int, int] = (0, 1)):
        """``shard=(index, count)`` keeps ``order[index::count]`` of each
        epoch's seeded shuffle: every rank draws the same order, so the
        shards are disjoint and together the whole epoch.  ``part=(index,
        count)`` then keeps, of each ``count · batch_size`` rows of the
        shard (a node's batch), rows ``[index · batch_size, (index + 1) ·
        batch_size)``, and drops the last node batch that is not whole."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(1, workers)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.depth = depth
        self.shard = shard
        self.part = part
        self.rng = np.random.default_rng(seed)

    def _epoch_order(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        index, count = self.shard
        if count > 1:
            order = order[index::count]
        index, count = self.part
        if count > 1:
            node_batch = count * self.batch_size
            whole = len(order) // node_batch * node_batch
            order = order[:whole].reshape(-1, count, self.batch_size)[:, index].reshape(-1)
        return order

    def _batches(self, order):
        b = self.batch_size
        end = len(order) - (len(order) % b if self.drop_last else 0)
        for i in range(0, end, b):
            yield order[i:i + b]

    def epoch(self):
        """One pass over the dataset as collated numpy batches."""
        stop = object()
        q: queue.Queue = queue.Queue(maxsize=self.depth)

        def produce():
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    for idxs in self._batches(self._epoch_order()):
                        items = list(pool.map(self.dataset.load, idxs))
                        q.put(collate(items))
                q.put(stop)
            except BaseException as exc:  # surface worker failures to the consumer
                q.put(exc)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            if isinstance(item, BaseException):
                # re-raise in the consuming thread: a bad record must fail the
                # epoch loudly, not silently truncate it
                raise item
            yield item

    def __iter__(self):
        while True:
            yield from self.epoch()


def _stage(batch: dict, keys, device: torch.device, stream):
    """Host batch → (device tensors, event after their copies) on ``stream``."""
    host = {k: torch.from_numpy(np.ascontiguousarray(batch[k])) for k in keys}
    if device.type != "cuda":
        return {k: v.to(device) for k, v in host.items()}, None
    with torch.cuda.stream(stream):
        out = {k: v.pin_memory().to(device, non_blocking=True) for k, v in host.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def overlap_device_puts(iterator, device, keys=None, depth: int = 2):
    """Yield each host batch of ``iterator`` as tensors on ``device``, its
    copy issued ahead from a side thread.

    ``keys`` selects the batch entries to copy (all by default); ``depth``
    bounds the batches in flight (2 = double buffering).  On a CUDA device
    the copies run on a side stream; before a batch is yielded the current
    stream waits on its event and takes over its memory
    (``record_stream``), so the batch is ready for any work queued after.
    Exceptions from the source or the copy re-raise at the consumer, as in
    :meth:`Loader.epoch`.
    """
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    stop = object()
    q: queue.Queue = queue.Queue(maxsize=depth)

    def produce():
        try:
            for batch in iterator:
                q.put(_stage(batch, keys or list(batch), device, stream))
            q.put(stop)
        except BaseException as exc:
            q.put(exc)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            return
        if isinstance(item, BaseException):
            raise item
        out, event = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            for v in out.values():
                v.record_stream(current)
        yield out
