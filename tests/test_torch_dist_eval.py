"""The port's eval across ranks on the CPU: ``cli/eval.py::run_eval`` on two
gloo ranks (processes spawned by ``parallel/collectives.py::run_ranks`` that
import torch and ``yolojax_torch`` only, ``tests/torch_dist_ranks.py``)
against the port's one-process eval and the JAX package's ``run_eval``,
whose ``detect_fn`` shards the batch over the test process's CPU devices.

``tests/test_torch_eval_cli.py``'s VOC workspace (full-width Darknet-19 in
f32 at 64², 7 test images, the JAX package's seeded weights with randomized
BN statistics), at ``[eval]``'s point (threshold 0.005, topk 300), global
batches of 16 (one batch, padded: rank 1's share is all padding) and 4 (the
final batch padded within rank 1's share).

Bounds: against one process, every rank's mAP and each class's AP within
1e-6, and the same detections in the same order; against the JAX package,
the mAP within 1e-4 and each AP within 1e-3, as in
``test_torch_eval_cli.py`` (XLA's and torch's convolutions sum in other
orders).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch_dist_ranks as ranks_mod

from test_torch_eval_cli import SIZE, _close, _jax_eval, _workspace
from yolojax.utils import checkpoint as jckpt
from yolojax_torch.config import get_model_dir, load_config
from yolojax_torch.parallel.collectives import run_ranks

BATCHES = (16, 4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The workspace's config args and the JAX package's weights, saved as
    its model dir's checkpoint."""
    cfg = _workspace(tmp_path_factory.mktemp("voc"), "voc")
    from yolojax.cli.common import build as jbuild
    from yolojax.config import load_config as jload_config

    _, _, jmodel = jbuild(jload_config(cfg[1:]))
    params, state = (jax.tree_util.tree_map(np.asarray, t)
                     for t in jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name in state:
        state[name]["mean"] = rng.normal(0, 0.1, state[name]["mean"].shape).astype(np.float32)
        state[name]["var"] = rng.uniform(0.8, 1.2, state[name]["var"].shape).astype(np.float32)
    model_dir = Path(get_model_dir(load_config(cfg[1:])))
    model_dir.mkdir(parents=True)
    jckpt.save(str(model_dir / "3.npz"), {"params": params, "state": state}, {"step": 3})
    return cfg, params, state


@pytest.fixture(scope="module")
def runs(setup):
    cfg = setup[0]
    return {"ranks": run_ranks(ranks_mod.eval_run, 2, cfg, BATCHES, SIZE),
            "one": ranks_mod.eval_run(None, cfg, BATCHES, SIZE)}


@pytest.mark.parametrize("batch", BATCHES)
def test_two_ranks_match_one_process(runs, batch):
    want = runs["one"][batch]
    assert len(want["detections"]) > 0 and want["map"] > 0
    for got in (r[batch] for r in runs["ranks"]):
        assert abs(got["map"] - want["map"]) <= 1e-6
        assert got["ap"].keys() == want["ap"].keys()
        assert all(abs(got["ap"][c] - ap) <= 1e-6 for c, ap in want["ap"].items())
        assert len(got["detections"]) == len(want["detections"])
        for g, w in zip(got["detections"], want["detections"]):
            assert g[:2] == w[:2] and abs(g[2] - w[2]) <= 1e-6 * abs(w[2])
            np.testing.assert_allclose(g[3] + g[4], w[3] + w[4], atol=1e-6)


def test_two_ranks_match_the_jax_sharded_eval(setup, runs):
    cfg, params, state = setup
    want = _jax_eval(cfg, params, state, batch=16)
    got = runs["ranks"][0][16]
    _close(got, want)
    assert len(got["detections"]) == sum(len(d) for d in want["recorder"].dets.values())
