"""Port parity, the host data feed: ``yolojax_torch.data`` (cache, dataset,
loader) against ``yolojax.data`` on the same records.

The record cache written by the JAX package's builder loads in the port;
``Dataset``/``collate`` give identical arrays (with cv2 decoding and with an
injected ``imread``, with and without the decoded-canvas memmap); ``Loader``
yields the same batches in the same order for one seed; and
``overlap_device_puts`` hands over the same batches as tensors and re-raises a
failure of its source or its copy at the consumer.
"""

import itertools
import pickle

import numpy as np
import pytest
import torch

from yolojax.data import cache as jcache
from yolojax.data import dataset as jdataset
from yolojax.data import loader as jloader
from yolojax_torch import config as tconfig
from yolojax_torch.data import cache, dataset, loader


def synth_records(rng, n=11):
    images, records = {}, []
    for i in range(n):
        h, w = int(rng.integers(20, 90)), int(rng.integers(20, 90))
        images[f"img{i}"] = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        k = int(rng.integers(0, 4))
        lo = rng.uniform(0, 0.5, (k, 2))
        records.append(jcache.make_record(f"img{i}", lo, lo + rng.uniform(0.1, 0.5, (k, 2)),
                                          rng.integers(0, 20, k), rng.uniform(size=k) < 0.2))
    return images, records


def test_make_record_and_cache_match(rng, tmp_path):
    _, records = synth_records(rng)
    for rec in records:
        got = cache.make_record(rec["path"], rec["yx_min"], rec["yx_max"], rec["cls"],
                                rec["difficult"])
        assert got.keys() == rec.keys()
        for k in rec:
            if k != "path":
                assert got[k].dtype == rec[k].dtype and np.array_equal(got[k], rec[k])
    config = tconfig.load_config(None, [f"config/root={tmp_path}"])
    assert cache.cache_path(config, "train") == jcache.cache_path(config, "train")
    assert tconfig.get_cache_dir(config) == str(tmp_path / "cache" / "20")
    with pytest.raises(FileNotFoundError, match="cache.py"):
        cache.load_cache(config, "train")
    (tmp_path / "cache" / "20").mkdir(parents=True)
    with open(jcache.cache_path(config, "train"), "wb") as f:
        pickle.dump(records, f)
    loaded = cache.load_cache(config, "train")
    assert [r["path"] for r in loaded] == [r["path"] for r in records]
    assert cache.PHASES == jcache.PHASES


@pytest.mark.parametrize("decoded", [False, True], ids=["decode", "memmap"])
def test_dataset_items_match(rng, tmp_path, decoded):
    images, records = synth_records(rng)
    images["img3"] = rng.integers(0, 256, (70, 130, 3), dtype=np.uint8)   # wider than the canvas
    kw = dict(canvas=96, max_boxes=3, imread=images.__getitem__)
    want = jdataset.Dataset(records, decoded_dir=str(tmp_path / "j") if decoded else None, **kw)
    got = dataset.Dataset(records, decoded_dir=str(tmp_path / "t") if decoded else None, **kw)
    assert len(got) == len(want) and dataset.GRAY == jdataset.GRAY
    items = [got.load(i) for i in range(len(got))]
    for i, item in enumerate(items):
        ref = want.load(i)
        assert item.keys() == ref.keys()
        for k in ref:
            assert item[k].dtype == ref[k].dtype and np.array_equal(item[k], ref[k]), (i, k)
    batch, ref = dataset.collate(items[:4]), jdataset.collate([want.load(i) for i in range(4)])
    assert all(np.array_equal(batch[k], ref[k]) for k in ref)


def test_dataset_decodes_files_with_cv2(rng, tmp_path):
    import cv2

    images, records = synth_records(rng, n=3)
    for rec in records:
        path = str(tmp_path / f"{rec['path']}.png")
        cv2.imwrite(path, images[rec["path"]][:, :, ::-1])
        rec["path"] = path
    want, got = jdataset.Dataset(records, canvas=96), dataset.Dataset(records, canvas=96)
    for i in range(3):
        assert np.array_equal(got.load(i)["canvas"], want.load(i)["canvas"])


def test_loader_batch_order_matches(rng):
    images, records = synth_records(rng)
    kw = dict(canvas=64, max_boxes=4, imread=images.__getitem__)
    want = jloader.Loader(jdataset.Dataset(records, **kw), 3, workers=2, seed=5)
    got = loader.Loader(dataset.Dataset(records, **kw), 3, workers=2, seed=5)
    # three epochs of 3 batches (11 records, the last 2 dropped)
    for b_got, b_want in zip(itertools.islice(got, 9), itertools.islice(want, 9)):
        assert b_got.keys() == b_want.keys()
        for k in b_want:
            assert np.array_equal(b_got[k], b_want[k]), k


def test_overlap_device_puts_hands_over_the_batches(rng):
    images, records = synth_records(rng)
    source = loader.Loader(dataset.Dataset(records, canvas=64, imread=images.__getitem__), 2,
                           seed=1)
    want = list(itertools.islice(iter(source.epoch()), 5))
    again = loader.Loader(dataset.Dataset(records, canvas=64, imread=images.__getitem__), 2,
                          seed=1)
    got = list(loader.overlap_device_puts(again.epoch(), "cpu", ("canvas", "valid")))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert set(g) == {"canvas", "valid"}
        assert isinstance(g["canvas"], torch.Tensor) and g["canvas"].device.type == "cpu"
        assert np.array_equal(g["canvas"].numpy(), w["canvas"])
        assert np.array_equal(g["valid"].numpy(), w["valid"])


def test_overlap_device_puts_propagates_errors():
    def source():
        yield {"x": np.zeros(3)}
        raise ValueError("bad record")

    it = loader.overlap_device_puts(source(), "cpu", depth=2)
    assert torch.equal(next(it)["x"], torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="bad record"):
        next(it)

    bad = loader.overlap_device_puts(iter([{"x": np.zeros(2)}]), "cpu", keys=("missing",))
    with pytest.raises(KeyError, match="missing"):
        next(bad)


def test_loader_surfaces_a_bad_record(rng):
    images, records = synth_records(rng, n=4)
    del images["img2"]
    it = iter(loader.Loader(dataset.Dataset(records, canvas=64, imread=images.__getitem__), 2,
                            seed=0, shuffle=False))
    next(it)
    with pytest.raises(KeyError, match="img2"):
        next(it)
