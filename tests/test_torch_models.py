"""Port parity, models and weights: yolojax_torch.models / utils.checkpoint
against yolojax on the CPU, in f32.

Weights come from the JAX package's init (with non-trivial BN statistics) and
cross through ``checkpoint.from_jax`` (HWIO → OIHW).  Tolerances: ``fold_bn``
rtol 1e-6 (elementwise f32); the narrow Darknet's raw head rtol/atol 1e-3
(23 convolutions summed in another order by XLA and by torch).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.models.blocks import BNConfig as JBNConfig
from yolojax.models.blocks import fold_bn as jfold_bn
from yolojax.models.darknet import Darknet as JDarknet
from yolojax.models import ChannelResolver as JChannelResolver
from yolojax.utils import checkpoint as jckpt
from yolojax_torch.cli.common import build, load_weights_auto
from yolojax_torch.config import load_config, parse_attr, torch_dtype
from yolojax_torch.models import PORTED_KERNELS, ChannelResolver, build_model, kernel_active
from yolojax_torch.models.blocks import BNConfig, fold_bn, leaky_relu
from yolojax_torch.models.darknet import Darknet
from yolojax_torch.models.engine import run_plan
from yolojax_torch.utils import checkpoint as ckpt

ANCHORS = np.asarray([[1.0, 1.0], [2.5, 2.5]], np.float32)
# narrow Darknet widths: 8–32 channels, c21 divisible by 4 for the darknet reorg
NARROW = {"c1": 8, "c2": 8, "c3": 16, "c4": 8, "c5": 16, "c6": 16, "c7": 8, "c8": 16,
          "c9": 32, "c10": 16, "c11": 32, "c12": 16, "c13": 32, "c14": 32, "c15": 16,
          "c16": 32, "c17": 16, "c18": 32, "c19": 32, "c20": 32, "c21": 8, "c22": 32}


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def jax_narrow_darknet(rng, num_classes=3, anchors=ANCHORS):
    """JAX narrow Darknet with fresh params and randomized BN statistics."""
    model = JDarknet(anchors=anchors, num_classes=num_classes, dtype=jnp.float32,
                     width=JChannelResolver(NARROW))
    params, state = model.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    for name in state:
        state[name]["mean"] = rng.normal(0, 0.2, state[name]["mean"].shape).astype(np.float32)
        state[name]["var"] = rng.uniform(0.5, 1.5, state[name]["var"].shape).astype(np.float32)
        params[name]["gamma"] = rng.uniform(0.5, 1.5, params[name]["gamma"].shape).astype(
            np.float32)
        params[name]["beta"] = rng.normal(0, 0.1, params[name]["beta"].shape).astype(np.float32)
    return model, params, state


@pytest.mark.parametrize("enable,gamma,beta", [(True, True, True), (True, False, True),
                                               (True, True, False), (False, True, True)])
def test_fold_bn_matches_jax(rng, enable, gamma, beta):
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    params = {"w": w, "gamma": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "beta": rng.normal(0, 1, 6).astype(np.float32)}
    state = {"mean": rng.normal(0, 1, 6).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    want = jfold_bn(params, state, JBNConfig(enable=enable, gamma=gamma, beta=beta))
    tp, ts = ckpt.from_jax({"l": params}, {"l": state})
    got = fold_bn(tp["l"], ts["l"], BNConfig(enable=enable, gamma=gamma, beta=beta))
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]).transpose(3, 2, 0, 1),
                               rtol=1e-6)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]), rtol=1e-6, atol=1e-7)


def test_leaky_relu_slope():
    x = torch.tensor([-2.0, -0.0, 0.0, 3.0])
    np.testing.assert_array_equal(leaky_relu(x).numpy(),
                                  np.float32([-2.0 * np.float32(0.1), 0.0, 0.0, 3.0]))


def test_narrow_darknet_apply_folded_matches_jax(rng):
    jmodel, params, state = jax_narrow_darknet(rng)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))

    model = Darknet(anchors=ANCHORS, num_classes=3, dtype=torch.float32,
                    width=ChannelResolver(NARROW))
    assert [(d.name, d.in_ch, d.out_ch) for d in model.layer_defs] == \
        [(d.name, d.in_ch, d.out_ch) for d in jmodel.layer_defs]
    tp, ts = ckpt.from_jax(params, state)
    with torch.no_grad():
        got = model.apply_folded(model.fold(tp, ts), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 2, 2, 2 * (5 + 3))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_darknet_fold_layout_and_dtypes(rng):
    model = Darknet(anchors=ANCHORS, num_classes=3, dtype=torch.bfloat16,
                    width=ChannelResolver(NARROW))
    params, state = model.init(torch.Generator().manual_seed(0))
    assert params["c1"]["w"].shape == (8, 3, 3, 3) and params["out"]["b"].shape == (16,)
    folded = model.fold(params, state)
    for lp in folded.values():
        assert lp["w"].dtype == torch.bfloat16 and lp["b"].dtype == torch.float32
        assert lp["w"].is_contiguous(memory_format=torch.channels_last)
    raw = model.apply_folded(folded, torch.rand(1, 64, 64, 3))
    assert raw.shape == (1, 2, 2, 16) and raw.dtype == torch.bfloat16
    assert raw.is_contiguous()
    # same seed, same weights
    again, _ = model.init(torch.Generator().manual_seed(0))
    torch.testing.assert_close(again["c22"]["w"], params["c22"]["w"], rtol=0, atol=0)


def test_run_plan_rejects_training():
    """A train-mode forward needs the unfolded params' BN state: the folded
    path refuses ``train=True``."""
    model = Darknet(anchors=ANCHORS, num_classes=3, width=ChannelResolver(NARROW))
    with pytest.raises(ValueError, match="BN state"):
        run_plan(model.plan, {}, torch.zeros(1, 64, 64, 3), train=True)


def test_checkpoint_loads_jax_npz(rng, tmp_path):
    overlay = tmp_path / "narrow.json"
    overlay.write_text(json.dumps(NARROW))
    config = load_config(None, [f"model/channels={overlay}"])
    _, anchors, model = build(config)
    _, params, state = jax_narrow_darknet(rng, model.num_classes, anchors)
    path = str(tmp_path / "7.npz")
    jckpt.save(path, {"params": params, "state": state}, {"step": 7})
    trees, meta = ckpt.load(path)
    assert meta == {"step": 7}
    np.testing.assert_array_equal(trees["params"]["c3"]["w"], params["c3"]["w"])
    np.testing.assert_array_equal(trees["state"]["c3"]["var"], state["c3"]["var"])
    assert ckpt.latest(str(tmp_path)) == path

    tp, ts, meta = load_weights_auto(config, model, path)
    assert meta["step"] == 7
    np.testing.assert_array_equal(tp["c3"]["w"].numpy(), params["c3"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ts["c3"]["mean"].numpy(), state["c3"]["mean"])


def test_checkpoint_shape_mismatch_raises(rng, tmp_path):
    _, params, state = jax_narrow_darknet(rng)   # 3 classes: head shape differs from VOC's 20
    path = str(tmp_path / "1.npz")
    jckpt.save(path, {"params": params, "state": state})
    overlay = tmp_path / "narrow.json"
    overlay.write_text(json.dumps(NARROW))
    config = load_config(None, [f"model/channels={overlay}"])
    _, _, model = build(config)
    with pytest.raises(ValueError, match="shape"):
        load_weights_auto(config, model, path)
    weights = tmp_path / "model.weights"        # a header and one float: no layer fits it
    np.concatenate([np.asarray([0, 2, 0], np.int32).view(np.uint8),
                    np.asarray([0], np.uint64).view(np.uint8),
                    np.ones(1, np.float32).view(np.uint8)]).tofile(weights)
    with pytest.raises(ValueError, match="truncated"):
        load_weights_auto(config, model, str(weights))


def test_config_resolves_to_the_port():
    config = load_config(None)
    model = build_model(config, ANCHORS, 20)
    assert type(model) is Darknet and model.dtype == torch.bfloat16
    assert model.pallas == frozenset({"nms", "fusedpost"}) and model.reorg_order == "darknet"
    assert kernel_active("fusedpost", model.pallas)
    assert kernel_active("nms", model.pallas)          # ported; fusedpost takes precedence
    assert not kernel_active("reorg", model.pallas)
    assert "pool" not in PORTED_KERNELS     # accepted; selects nothing (engine.route)
    assert parse_attr("yolojax.data.transform.stretch").__module__ == \
        "yolojax_torch.data.transform"
    assert parse_attr("yolojax.data.device_cache.DeviceDataset").__module__ == \
        "yolojax_torch.data.device_cache"
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        torch_dtype("float16")


@pytest.mark.parametrize("path,error,missing", [
    # the JAX package's mesh sizing has no counterpart: a rank cannot be left
    # idle, so the port's train CLI raises where the JAX package shrinks its mesh
    ("yolojax.parallel.mesh.make_mesh_for_batch", AttributeError,
     "yolojax_torch.parallel.mesh.make_mesh_for_batch"),
])
def test_unported_config_values_name_the_missing_part(path, error, missing):
    with pytest.raises(error, match=missing):
        parse_attr(path)
