"""Darknet ``.weights`` import and export in the port against
``yolojax.tools.darknet``.

A file written by the JAX package's ``save_weights`` from seeded params (BN
statistics randomized) loads through both packages; the port's arrays must
equal the reference's after ``checkpoint.from_jax`` (HWIO → OIHW), the head's
output channels permuted xy → yx.  The port's writer must write the same
bytes, its loader must refuse a truncated or overlong file with the
reference's messages, and with ``reinit_head`` a file of another class count
keeps every trunk layer and a fresh head of the model's shape.  The
``load_weights_auto`` branch and ``cli/convert_darknet.py`` (both ways) go
through the same files.
"""

import filecmp
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolojax.tools.darknet as jdarknet
from yolojax.models import ChannelResolver as JChannelResolver
from yolojax.models.darknet import Darknet as JDarknet
from yolojax.models.darknet import Tiny as JTiny
from yolojax.utils import checkpoint as jckpt
import yolojax_torch.tools.darknet as tdarknet
from yolojax_torch.cli.common import load_weights_auto
from yolojax_torch.cli.convert_darknet import main as convert_main
from yolojax_torch.config import load_config
from yolojax_torch.models import ChannelResolver
from yolojax_torch.models.darknet import Darknet, Tiny
from yolojax_torch.utils import checkpoint as ckpt

ANCHORS = np.asarray([[1.0, 1.0], [2.0, 3.0]], np.float32)
# narrow Darknet widths (8–32 channels; c21 divisible by 4 for the darknet reorg)
NARROW = {"c1": 8, "c2": 8, "c3": 16, "c4": 8, "c5": 16, "c6": 16, "c7": 8, "c8": 16,
          "c9": 32, "c10": 16, "c11": 32, "c12": 16, "c13": 32, "c14": 32, "c15": 16,
          "c16": 32, "c17": 16, "c18": 32, "c19": 32, "c20": 32, "c21": 8, "c22": 32}
NARROW_TINY = {"c1": 8, "c2": 8, "c3": 16, "c4": 16, "c5": 32, "c6": 32, "c7": 64, "c8": 64}


def models(kind: str, num_classes: int):
    """(JAX model, port model) of one architecture, at narrow widths."""
    if kind == "tiny":
        return (JTiny(anchors=ANCHORS, num_classes=num_classes, dtype=jnp.float32,
                      width=JChannelResolver(NARROW_TINY)),
                Tiny(anchors=ANCHORS, num_classes=num_classes, dtype=torch.float32,
                     width=ChannelResolver(NARROW_TINY)))
    return (JDarknet(anchors=ANCHORS, num_classes=num_classes, dtype=jnp.float32,
                     width=JChannelResolver(NARROW)),
            Darknet(anchors=ANCHORS, num_classes=num_classes, dtype=torch.float32,
                    width=ChannelResolver(NARROW)))


@pytest.fixture(scope="module")
def jax_weights():
    """``write(path, kind, seed, seen)``: a ``.weights`` file written by the
    JAX package from its seeded init of a 3-class model (one init per kind),
    with BN statistics and the head's bias drawn from ``seed``; returns the
    (JAX model, port model, params, state) it wrote."""
    inits = {}

    def write(path, kind: str, seed: int, seen: int = 12800):
        jmodel, tmodel = models(kind, 3)
        if kind not in inits:
            inits[kind] = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
        params, state = jax.tree_util.tree_map(np.copy, inits[kind])
        rng = np.random.default_rng(seed)
        for name in state:
            state[name]["mean"] = rng.normal(0, 0.2, state[name]["mean"].shape).astype(np.float32)
            state[name]["var"] = rng.uniform(0.5, 1.5, state[name]["var"].shape).astype(np.float32)
        params["out"]["b"] = rng.normal(0, 1, params["out"]["b"].shape).astype(np.float32)
        jdarknet.save_weights(str(path), jmodel, params, state, seen=seen)
        return jmodel, tmodel, params, state

    return write


def equal_trees(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].keys() == want[k].keys(), k
        for n in want[k]:
            assert got[k][n].dtype == want[k][n].dtype == torch.float32
            assert torch.equal(got[k][n], want[k][n]), (k, n)


@pytest.mark.parametrize("kind", ["tiny", "darknet"])
def test_weights_load_to_the_reference_arrays(tmp_path, jax_weights, kind):
    path = tmp_path / "w.weights"
    jmodel, tmodel, jparams, _ = jax_weights(path, kind, seed=1)
    params, state, seen = tdarknet.load_weights(str(path), tmodel)
    wp, ws, wseen = jdarknet.load_weights(str(path), jmodel)
    assert seen == wseen == 12800
    want = ckpt.from_jax(jax.tree_util.tree_map(np.asarray, wp),
                         jax.tree_util.tree_map(np.asarray, ws))
    equal_trees(params, want[0])
    equal_trees(state, want[1])
    # the file holds the head in darknet's xy field order, the model in yx order
    perm = tdarknet.head_permutation(len(ANCHORS), 3)
    assert np.array_equal(perm, jdarknet.head_permutation(len(ANCHORS), 3))
    n, fan_in = 2 * 8, tmodel.layer_defs[-1].in_ch
    stored = np.fromfile(path, np.float32)[-(n + n * fan_in):]
    assert np.array_equal(params["out"]["b"].numpy(), jparams["out"]["b"])
    assert np.array_equal(stored[:n], jparams["out"]["b"][perm])
    assert not np.array_equal(stored[:n], jparams["out"]["b"])
    assert np.array_equal(params["out"]["w"].numpy()[perm].reshape(-1), stored[n:])


@pytest.mark.parametrize("kind", ["tiny", "darknet"])
def test_round_trip_writes_the_same_bytes(tmp_path, jax_weights, kind):
    path, back = tmp_path / "w.weights", tmp_path / "back.weights"
    _, tmodel, _, _ = jax_weights(path, kind, seed=2, seen=777)
    params, state, seen = tdarknet.load_weights(str(path), tmodel)
    tdarknet.save_weights(str(back), tmodel, params, state, seen=seen)
    assert filecmp.cmp(path, back, shallow=False)
    again = tdarknet.load_weights(str(back), tmodel)
    equal_trees(again[0], params)
    equal_trees(again[1], state)
    assert again[2] == 777


@pytest.mark.parametrize("change", ["truncated", "overlong", "header only"])
def test_a_file_that_does_not_fit_raises_as_the_reference_raises(tmp_path, jax_weights, change):
    path = tmp_path / "w.weights"
    jmodel, tmodel, _, _ = jax_weights(path, "tiny", seed=3)
    data = np.fromfile(path, np.uint8)
    data = {"truncated": data[:-4], "overlong": np.concatenate([data, data[-8:]]),
            "header only": data[:20]}[change]
    data.tofile(path)
    with pytest.raises(ValueError) as want:
        jdarknet.load_weights(str(path), jmodel)
    with pytest.raises(ValueError) as got:
        tdarknet.load_weights(str(path), tmodel)
    assert str(got.value) == str(want.value)
    assert ("truncated" if change != "overlong" else "not fully consumed") in str(got.value)


def test_reinit_head_keeps_the_trunk_and_draws_a_fresh_head(tmp_path, jax_weights):
    jmodel5, tmodel5 = models("tiny", 5)
    path = tmp_path / "w.weights"
    jax_weights(path, "tiny", seed=4)
    for load, model in ((jdarknet.load_weights, jmodel5), (tdarknet.load_weights, tmodel5)):
        with pytest.raises(ValueError, match="truncated|not fully consumed"):
            load(str(path), model)
    params, state, seen = tdarknet.load_weights(str(path), tmodel5,
                                                reinit_head_on_mismatch=True, head_rng_seed=7)
    wp, ws, wseen = jdarknet.load_weights(str(path), jmodel5, reinit_head_on_mismatch=True,
                                          head_rng_seed=7)
    want = ckpt.from_jax(jax.tree_util.tree_map(np.asarray, wp),
                         jax.tree_util.tree_map(np.asarray, ws))
    head = params.pop("out")
    want[0].pop("out")
    equal_trees(params, want[0])
    equal_trees(state, want[1])
    assert seen == wseen
    fresh, _ = tmodel5.init(torch.Generator().manual_seed(7))
    d = tmodel5.layer_defs[-1]
    assert head["w"].shape == (2 * 10, d.in_ch, 1, 1) and head["b"].shape == (20,)
    assert torch.equal(head["b"], torch.zeros(20)) and float(head["w"].std()) > 0
    assert np.isclose(float(head["w"].std()), float(fresh["out"]["w"].std()), rtol=0.5)
    # bytes left that no channel count explains
    data = np.fromfile(path, np.uint8)
    np.concatenate([data, data[-4:]]).tofile(path)
    with pytest.raises(ValueError, match="do not parse"):
        tdarknet.load_weights(str(path), tmodel5, reinit_head_on_mismatch=True)


def test_load_weights_auto_and_convert_darknet(tmp_path, jax_weights):
    """``-f x.weights`` through ``load_weights_auto``, and the convert CLI:
    .weights → npz that the JAX package loads, and ``--reverse`` back to the
    same bytes."""
    names = tmp_path / "cat3"
    names.write_text("a\nb\nc\n")
    anchors = tmp_path / "anchors.tsv"
    anchors.write_text("1.0\t1.0\n2.0\t3.0\n")
    widths = tmp_path / "narrow.json"
    widths.write_text(json.dumps(NARROW_TINY))
    mods = [f"config/root={tmp_path}/art", f"cache/category={names}",
            f"model/anchors={anchors}", "model/dnn=yolojax.models.darknet.Tiny",
            "model/dtype=float32", f"model/channels={widths}"]
    config = load_config(None, mods)
    path = tmp_path / "w.weights"
    jmodel, tmodel, jparams, jstate = jax_weights(path, "tiny", seed=5, seen=64)
    params, state, meta = load_weights_auto(config, tmodel, str(path))
    assert meta == {"seen": 64}
    want = tdarknet.load_weights(str(path), tmodel)
    equal_trees(params, want[0])

    argv = ["-m", *mods]
    npz = tmp_path / "art" / "model" / "cat3" / "Tiny" / "model" / "0.npz"
    assert convert_main([str(path), *argv]) == 0 and npz.exists()
    trees, jmeta = jckpt.load(str(npz), {"params": jparams, "state": jstate})
    assert jmeta == {"step": 0, "seen": 64}
    wp, ws, _ = jdarknet.load_weights(str(path), jmodel)
    for k in wp:
        for n in wp[k]:
            np.testing.assert_array_equal(np.asarray(trees["params"][k][n]), np.asarray(wp[k][n]))
    back = tmp_path / "back.weights"
    assert convert_main([str(npz), "--reverse", "-o", str(back), *argv]) == 0
    assert filecmp.cmp(path, back, shallow=False)
