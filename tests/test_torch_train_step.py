"""Port parity, the train step: three steps of
``yolojax_torch.parallel.mesh.make_train_step`` against
``yolojax.parallel.mesh.make_train_step`` (no mesh), f32 on the CPU, from the
same params (carried across by ``checkpoint.from_jax``) on the same batches.

Full-width Darknet-19 and Tiny and MobileNet at 64², B=2, G=3, VOC's 20
classes and five anchors.  The optimizer is built from config by both
packages' ``build_optimizer``: sgd with clip, BN-γ sparsity, weight decay,
momentum and a milestone at step 2 (so the third step runs at the decayed
rate); one case with adam, one with ``with_frozen``.  Each step compares the
five loss components, ``total`` and ``grad_norm``: rtol 1e-4 at the first
step, 1e-3 at the later ones.  After the last step it compares, each as the
L2 norm of the difference over the whole model relative to the JAX
package's: the params' change over the three steps (1e-2), the momentum
trace (3e-2), the BN state (1e-5); and the optimizer count.

Why these bounds: at 64² the deep layers of Darknet-19 and MobileNet see
2×2 and 4×4 maps, so BN normalizes by the variance of 8 to 32 samples over
B=2, which amplifies the float32 rounding differences of the two libraries'
convolutions.  Measured on a CPU: up to 6e-4 on the components at step 3,
2e-3 on the params' change, 1.1e-2 on the trace (MobileNet), and gradients
of BN scales with small norms as far (up to 3 %) from a float64 run of the
port in the JAX package's float32 as in the port's.
"""

import configparser

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.models.darknet import Darknet as JaxDarknet
from yolojax.models.darknet import Tiny as JaxTiny
from yolojax.models.mobilenet import MobileNet as JaxMobileNet
from yolojax.ops.loss import LossConfig as JaxLossConfig
from yolojax.parallel.mesh import make_train_step as jax_make_train_step
from yolojax.utils.train import build_optimizer as jax_build_optimizer
from yolojax.utils.train import with_frozen as jax_with_frozen
from yolojax_torch.models.darknet import Darknet, Tiny
from yolojax_torch.models.mobilenet import MobileNet
from yolojax_torch.ops.loss import LossConfig
from yolojax_torch.parallel.mesh import loss_weights_from_config, make_train_step
from yolojax_torch.utils.checkpoint import from_jax
from yolojax_torch.utils.train import build_optimizer, with_frozen

ANCHORS = np.asarray([[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11], [16.62, 10.52]],
                     np.float32)
MODELS = {"darknet": (JaxDarknet, Darknet), "tiny": (JaxTiny, Tiny),
          "mobilenet": (JaxMobileNet, MobileNet)}
STEPS = 3


def train_config(optimizer="sgd", **extra):
    config = configparser.ConfigParser()
    config.read_dict({"train": {
        "optimizer": f"yolojax.utils.train.{optimizer}", "learning_rate": "1e-3",
        "momentum": "0.9", "weight_decay": "5e-4", "milestones": "2", "gamma": "0.1",
        "clip": "5.0", "sparsity": "0.01", **extra}, "loss": {}})
    return config


def batches(seed, b=2, s=64, g=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        center = rng.uniform(0.3, 0.7, (b, g, 2)).astype(np.float32)
        half = rng.uniform(0.05, 0.25, (b, g, 2)).astype(np.float32)
        out.append({"images": rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32),
                    "yx_min": np.clip(center - half, 0, 1), "yx_max": np.clip(center + half, 0, 1),
                    "cls": rng.integers(0, 20, (b, g)).astype(np.int32),
                    "valid": np.ones((b, g), bool)})
    return out


def first_leaf(tree, name):
    """The JAX optimizer state's ``count`` / ``trace`` leaf (the path holds it)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if name in jax.tree_util.keystr(path):
            return path, leaf
    raise KeyError(name)


def jax_trace(opt_state):
    """The JAX sgd state's momentum trace as ``{layer: {name: array}}``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        keys = [p.key for p in path if isinstance(p, jax.tree_util.DictKey)]
        if "trace" in jax.tree_util.keystr(path):
            out.setdefault(keys[-2], {})[keys[-1]] = np.asarray(leaf)
    return out


def rel_err(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want‖ over every leaf of two ``{layer: {name: array}}``."""
    diff = sum(np.sum((got[k][n] - want[k][n]) ** 2) for k in want for n in want[k])
    norm = sum(np.sum(want[k][n] ** 2) for k in want for n in want[k])
    assert got.keys() == want.keys()
    return float(np.sqrt(diff / norm))


def numpy_tree(tree):
    return {k: {n: v.numpy() for n, v in lp.items()} for k, lp in tree.items()}


def run_pair(name, config, frozen=(), seen=0):
    jax_cls, port_cls = MODELS[name]
    jmodel = jax_cls(anchors=ANCHORS, num_classes=20, dtype=jnp.float32)
    model = port_cls(anchors=ANCHORS, num_classes=20, dtype=torch.float32)
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    params, state = from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             jax.tree_util.tree_map(np.asarray, jstate))
    jopt, opt = jax_build_optimizer(config), build_optimizer(config)
    if frozen:
        jopt, opt = jax_with_frozen(jopt, jparams, frozen), with_frozen(opt, params, frozen)
    jopt_state, opt_state = jopt.init(jparams), opt.init(params)
    weights = loss_weights_from_config(config)
    jstep = jax_make_train_step(jmodel, jopt, weights, JaxLossConfig())
    step = make_train_step(model, opt, weights, LossConfig())
    before = {k: {n: v.clone() for n, v in lp.items()} for k, lp in params.items()}

    for i, batch in enumerate(batches(7)):
        jparams, jstate, jopt_state, jm = jstep(jparams, jstate, jopt_state, batch,
                                                jnp.int32(seen))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        params, state, opt_state, m = step(params, state, opt_state, tb, seen)
        for k in ("coord", "object", "noobject", "cls", "prior", "total", "grad_norm"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4 if i == 0 else 1e-3,
                                       err_msg=f"step {i}: {k}")
        assert m["grads"].keys() == params.keys()

    want_params, want_state = (numpy_tree(t) for t in from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), jax.tree_util.tree_map(np.asarray, jstate)))
    start = numpy_tree(before)
    change = lambda tree: {k: {n: v - start[k][n] for n, v in lp.items()} for k, lp in tree.items()}
    assert rel_err(change(numpy_tree(params)), change(want_params)) < 1e-2
    assert rel_err(numpy_tree(state), want_state) < 1e-5
    assert opt_state["count"] == int(first_leaf(jopt_state, "count")[1]) == STEPS
    if "trace" in opt_state:
        trace = {k: {n: v.transpose(3, 2, 0, 1) if n == "w" else v for n, v in lp.items()}
                 for k, lp in jax_trace(jopt_state).items()}
        assert rel_err(numpy_tree(opt_state["trace"]), trace) < 3e-2
    return before, params, state


@pytest.mark.parametrize("name", sorted(MODELS))
def test_three_sgd_steps_match(name):
    before, params, state = run_pair(name, train_config())
    assert all(not torch.equal(before[k]["w"], params[k]["w"]) for k in params)


def test_three_adam_steps_match():
    run_pair("tiny", train_config("adam", weight_decay="1e-3"), seen=20000)


def test_frozen_layers_match_and_stay():
    before, params, _ = run_pair("tiny", train_config(), frozen=("c1", "c2"))
    for k in ("c1", "c2"):
        for n in params[k]:
            assert torch.equal(before[k][n], params[k][n])
    assert not torch.equal(before["c7"]["w"], params["c7"]["w"])
