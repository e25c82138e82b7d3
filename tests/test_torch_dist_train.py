"""The port's data-parallel train step on the CPU: two gloo ranks, each a
process spawned by ``parallel/collectives.py::run_ranks`` that imports torch
and ``yolojax_torch`` only (``tests/torch_dist_ranks.py``), against one
process on the global batch and against the JAX package's sharded step.

Full-width Darknet-19 at 64², VOC's 20 classes and five anchors, B=2 per
rank (a global batch of 4), 3 boxes an image, three steps of
``test_torch_train_step.py``'s sgd (clip, sparsity, weight decay, momentum,
a milestone at step 2):

* in float64 with the fused augmentation (each rank applies its rows of the
  global batch's draws), against the port's one-process step on the global
  batch (run by rank 0 after the two-rank run, which then sends only how far
  apart the two lie: full-width trees are hundreds of MB): ``grad_norm``,
  the params, the BN state and the momentum trace within rtol 1e-9, and the
  ranks bit-identical to each other.  The loss
  computes in float32 in both packages (``ops/loss.py`` casts the head), so
  its five components and ``total`` are means of float32 values summed in
  another order, held at 1e-6 (a few float32 ulps);
* in float32 without augmentation, from the JAX package's seeded params,
  against ``yolojax.parallel.mesh.make_train_step(mesh=make_mesh(2))`` on
  the global batch, at ``test_torch_train_step.py``'s tolerances;
* a control: rank 0's BN running state after the first step lies more than
  1e-3 (relative) from a one-device step on rank 0's half alone, so a
  missing sync of the statistics would fail the comparisons above;
* ``entry.dryrun_multichip(2, device="cpu")`` prints its OK line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_ranks as ranks_mod
from torch_dist_ranks import change, numpy_tree, rel_err

from yolojax.models.darknet import Darknet as JaxDarknet
from yolojax.ops.loss import LossConfig as JaxLossConfig
from yolojax.parallel.mesh import make_mesh
from yolojax.parallel.mesh import make_train_step as jax_make_train_step
from yolojax.utils.train import build_optimizer as jax_build_optimizer
from yolojax_torch.entry import dryrun_multichip
from yolojax_torch.models.darknet import Darknet
from yolojax_torch.ops.loss import LossConfig
from yolojax_torch.parallel.collectives import run_ranks
from yolojax_torch.parallel.mesh import loss_weights_from_config, make_train_step
from yolojax_torch.utils.checkpoint import from_jax
from yolojax_torch.utils.train import build_optimizer
from test_torch_train_step import first_leaf, jax_trace

GLOBAL = 4
PARITY = {"components": 1e-6, "tree": 1e-9}      # float64, see the module docstring


def _jax_init():
    """The JAX package's seeded Darknet-19 in f32, and the same as numpy trees
    in the port's layouts."""
    jmodel = JaxDarknet(anchors=ranks_mod.ANCHORS, num_classes=20, dtype=jnp.float32)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    params, state = from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             jax.tree_util.tree_map(np.asarray, jstate))
    return jmodel, jparams, jstate, numpy_tree(params), numpy_tree(state)


@pytest.fixture(scope="module")
def runs():
    """Both ranks' runs (one spawn; rank 0 also runs the float64 one on the
    global batch in one process) and the JAX pieces."""
    jmodel, jparams, jstate, params, state = _jax_init()
    ranks = run_ranks(ranks_mod.both_runs, 2, GLOBAL, params, state)
    f32 = ranks[0]["f32"]
    for key in ("params", "state", "trace", "state_1"):
        f32[key] = numpy_tree(f32[key])
    return {"ranks": ranks, "jax": (jmodel, jparams, jstate), "init": (params, state)}


@pytest.mark.parametrize("what", ["metrics", "params", "state", "trace"])
def test_two_ranks_match_one_process_in_float64(runs, what):
    got = runs["ranks"][0]["f64"]
    one = got["one"]
    if what == "metrics":
        for i, (m, want) in enumerate(zip(got["metrics"], one["metrics"])):
            np.testing.assert_allclose(m["grad_norm"], want["grad_norm"], rtol=PARITY["tree"],
                                       err_msg=f"step {i}")
            for k in ranks_mod.COMPONENTS[:-1]:
                np.testing.assert_allclose(m[k], want[k], rtol=PARITY["components"],
                                           err_msg=f"step {i}: {k}")
    elif what == "params":
        assert one["change"] < PARITY["tree"] and one["params"] < PARITY["tree"]
    else:
        assert one[what] < PARITY["tree"]
    assert got["count"] == one["count"] == ranks_mod.STEPS


@pytest.mark.parametrize("run", ["f64", "f32"])
def test_ranks_end_bit_identical(runs, run):
    a, b = (r[run] for r in runs["ranks"])
    assert a["metrics"] == b["metrics"]
    assert a["digest"] == b["digest"] and len(a["digest"]) > 100


def test_two_ranks_match_the_jax_sharded_step(runs):
    jmodel, jparams, jstate = runs["jax"]
    config = ranks_mod.train_config()
    jopt = jax_build_optimizer(config)
    jopt_state = jopt.init(jparams)
    jstep = jax_make_train_step(jmodel, jopt, loss_weights_from_config(config),
                                JaxLossConfig(), mesh=make_mesh(2))
    got = runs["ranks"][0]["f32"]
    for i, batch in enumerate(ranks_mod.global_batches(GLOBAL, False)):
        jparams, jstate, jopt_state, jm = jstep(jparams, jstate, jopt_state, batch, jnp.int32(0))
        for k in ranks_mod.COMPONENTS:
            np.testing.assert_allclose(got["metrics"][i][k], float(jm[k]),
                                       rtol=1e-4 if i == 0 else 1e-3, err_msg=f"step {i}: {k}")
    want_params, want_state = (numpy_tree(t) for t in from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), jax.tree_util.tree_map(np.asarray, jstate)))
    start = runs["init"][0]
    assert rel_err(change(got["params"], start), change(want_params, start)) < 1e-2
    assert rel_err(got["state"], want_state) < 1e-5
    assert got["count"] == int(first_leaf(jopt_state, "count")[1]) == ranks_mod.STEPS
    trace = {k: {n: v.transpose(3, 2, 0, 1) if n == "w" else v for n, v in lp.items()}
             for k, lp in jax_trace(jopt_state).items()}
    assert rel_err(got["trace"], trace) < 3e-2


def test_unsynchronized_bn_would_be_seen(runs):
    """Rank 0's half alone, one step on one device: its BN running state lies
    far from the synchronized one that the comparisons above hold."""
    params, state = ({k: {n: torch.from_numpy(v) for n, v in lp.items()} for k, lp in t.items()}
                     for t in runs["init"])
    config = ranks_mod.train_config()
    optimizer = build_optimizer(config)
    model = Darknet(anchors=ranks_mod.ANCHORS, num_classes=20, dtype=torch.float32)
    step = make_train_step(model, optimizer, loss_weights_from_config(config), LossConfig())
    batch = ranks_mod.global_batches(GLOBAL, False)[0]
    half = {k: torch.from_numpy(v[:GLOBAL // 2]) for k, v in batch.items()}
    _, alone, _, _ = step(params, state, optimizer.init(params), half, 0)
    synced = runs["ranks"][0]["f32"]["state_1"]
    start = numpy_tree(state)
    assert rel_err(numpy_tree(alone), synced) > 1e-3
    assert rel_err(change(numpy_tree(alone), start), change(synced, start)) > 0.1


def test_dryrun_multichip_on_the_cpu(capfd):
    dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert "dryrun_multichip(2): backbone Darknet total loss" in out
    assert out.rstrip().endswith("OK")
