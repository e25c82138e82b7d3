"""The port's device-resident dataset (``data/device_cache.py``) and the
Loader's shards, on the CPU — the port of ``tests/test_device_dataset.py``.

* the gather equals the host ``collate`` of the same rows, exactly,
  out-of-range indices clamped as JAX's ``take(mode="clip")``, and the
  chunked upload gives the same arrays;
* the epochs are the Loader's: the same seed gives the same batches;
* the batches equal ``yolojax.data.device_cache.DeviceDataset`` on a
  one-device mesh at the same seed, bit for bit;
* two ranks' shares (``shard=(i, 2)``), concatenated, are the one-rank
  batches of the global batch;
* ``Loader(shard=(i, 2))`` yields the JAX package's ``Loader(shard=(i, 2))``
  batches.
"""

import numpy as np
import pytest
import torch

from yolojax.data.dataset import Dataset as JaxDataset
from yolojax.data.device_cache import DeviceDataset as JaxDeviceDataset
from yolojax.data.loader import Loader as JaxLoader
from yolojax.parallel.mesh import make_mesh
from yolojax_torch.data import device_cache
from yolojax_torch.data.dataset import Dataset, collate
from yolojax_torch.data.device_cache import KEYS, DeviceDataset
from yolojax_torch.data.loader import Loader


def records(n, max_boxes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        k = int(rng.integers(1, max_boxes + 1))
        mins = rng.uniform(0.0, 0.5, (k, 2)).astype(np.float32)
        out.append({"path": f"img{i}", "yx_min": mins,
                    "yx_max": (mins + rng.uniform(0.1, 0.4, (k, 2))).clip(0, 1).astype(np.float32),
                    "cls": rng.integers(0, 3, (k,)).astype(np.int32),
                    "difficult": np.zeros((k,), bool)})
    return out


def imread(path):
    return np.random.default_rng(int(path[3:])).integers(0, 255, (48, 56, 3), dtype=np.uint8)


def fake_dataset(n=10, canvas=64, max_boxes=4, seed=0, cls=Dataset):
    return cls(records(n, max_boxes, seed), canvas=canvas, max_boxes=max_boxes, imread=imread)


def equal(got: dict, want: dict):
    assert set(got) == set(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == want[k].dtype, k


def test_gather_matches_host_collate():
    ds = fake_dataset()
    dd = DeviceDataset(ds, "cpu", batch_size=4, seed=0)
    equal(dd.gather(np.asarray([7, 0, 3, 3])), collate([ds.load(i) for i in (7, 0, 3, 3)]))
    equal(dd.gather([-2, 12]), collate([ds.load(i) for i in (0, 9)]))     # clamped
    assert dd.nbytes == sum(collate([ds.load(i) for i in range(10)])[k].nbytes for k in KEYS)


def test_chunked_upload_keeps_every_array(monkeypatch):
    ds = fake_dataset()
    whole = DeviceDataset(ds, "cpu", batch_size=4)
    monkeypatch.setattr(device_cache, "CHUNK_BYTES", 1000)    # canvases in many copies
    chunked = DeviceDataset(ds, "cpu", batch_size=4)
    for k in KEYS:
        assert chunked.arrays[k].dtype == whole.arrays[k].dtype
        assert torch.equal(chunked.arrays[k], whole.arrays[k]), k


def test_epoch_order_matches_loader():
    ds = fake_dataset(n=9)
    dd = iter(DeviceDataset(ds, "cpu", batch_size=4, seed=5))
    batches = list(Loader(ds, 4, workers=1, seed=5).epoch())
    assert len(batches) == 2
    for want in batches:
        equal(next(dd), {k: want[k] for k in KEYS})


def test_batches_match_the_jax_device_dataset():
    ours = iter(DeviceDataset(fake_dataset(n=11), "cpu", batch_size=3, seed=2))
    theirs = iter(JaxDeviceDataset(fake_dataset(n=11, cls=JaxDataset), make_mesh(1),
                                   batch_size=3, seed=2))
    for _ in range(7):          # past the end of the first epoch
        want = next(theirs)
        equal(next(ours), {k: np.asarray(want[k]) for k in KEYS})


def test_two_ranks_shares_concatenate_to_the_global_batch():
    ds = fake_dataset(n=13)
    one = iter(DeviceDataset(ds, "cpu", batch_size=4, seed=3))
    shares = [iter(DeviceDataset(ds, "cpu", batch_size=2, seed=3, shard=(i, 2))) for i in (0, 1)]
    for _ in range(5):          # 3 global batches an epoch
        parts = [next(s) for s in shares]
        equal({k: torch.cat([p[k] for p in parts]) for k in KEYS},
              {k: v.numpy() for k, v in next(one).items()})


@pytest.mark.parametrize("index", [0, 1])
def test_loader_shard_matches_the_jax_loader(index):
    ours = Loader(fake_dataset(n=11), 2, workers=1, seed=4, shard=(index, 2))
    theirs = JaxLoader(fake_dataset(n=11, cls=JaxDataset), 2, workers=1, seed=4,
                       shard=(index, 2))
    for _ in range(2):          # two epochs
        got, want = list(ours.epoch()), list(theirs.epoch())
        assert len(got) == len(want) == (6 - index) // 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
