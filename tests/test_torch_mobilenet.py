"""Port parity, the MobileNet detect slice: yolojax_torch against yolojax on
the CPU, in f32, at full width (routing gates read the real channel counts),
with weights carried over by ``checkpoint.from_jax``.

Tolerances: raw heads rtol/atol 1e-3 (the bound of test_torch_models.py:
32 convolutions summed in another order by XLA and by torch); detect:
``keep`` exact, conf rtol 1e-4 and corners atol 1e-4, as
test_torch_inference.py holds Darknet.  Routing compares which layers the
two engines send to the depthwise kernels, with the JAX kernels run in
interpret mode.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import yolojax.cli.common as jcommon
import yolojax.cli.detect as jdetect
import yolojax.kernels.dwconv as jdwconv
import yolojax.kernels.dwsep as jdwsep
import yolojax.models as jmodels
from yolojax.models.inference import Inference as JInference
from yolojax.models.mobilenet import MobileNet as JMobileNet
from yolojax.utils import checkpoint as jckpt
from yolojax_torch.cli import common as tcommon
from yolojax_torch.cli import detect as tdetect
from yolojax_torch.config import load_config
from yolojax_torch.kernels import dwconv as dk
from yolojax_torch.kernels import dwsep as sk
from yolojax_torch.models import LayerDef
from yolojax_torch.models.engine import resolve_in_channels
from yolojax_torch.models.inference import Inference
from yolojax_torch.models.mobilenet import MobileNet
from yolojax_torch.utils.checkpoint import from_jax

TOKENS = frozenset({"nms", "fusedpost", "dwsep", "dwconv"})
REPO = Path(__file__).resolve().parents[1]
CONFIGS = [str(REPO / "config.ini"), str(REPO / "config" / "mobilenet.ini")]


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(scope="module")
def jax_mobilenet():
    """Full-width JAX MobileNet (4 classes) with randomized BN statistics."""
    rng = np.random.default_rng(7)
    anchors = rng.uniform(0.5, 3.0, (5, 2)).astype(np.float32)
    model = JMobileNet(anchors=anchors, num_classes=4, dtype=jnp.float32)
    params, state = _randomize_bn(rng, *model.init(jax.random.PRNGKey(3)))
    return model, params, state


def _randomize_bn(rng, params, state):
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    for name in state:
        shape = state[name]["mean"].shape
        state[name]["mean"] = rng.normal(0, 0.2, shape).astype(np.float32)
        state[name]["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        params[name]["gamma"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        params[name]["beta"] = rng.normal(0, 0.1, shape).astype(np.float32)
    return params, state


def _port(jmodel, pallas=frozenset()):
    return MobileNet(anchors=jmodel.anchors, num_classes=jmodel.num_classes,
                     dtype=torch.float32, pallas=pallas)


def _defs(model):
    return [(d.name, d.in_ch, d.out_ch, d.ksize, d.groups, d.stride, d.bn, d.act)
            for d in model.layer_defs]


def test_resolve_in_channels_turns_the_depthwise_marker_into_in_ch():
    plan = [("conv", LayerDef("a", 24, 3)), ("conv", LayerDef("dw", 24, 3, groups=-1)),
            ("mark", "s"), ("conv", LayerDef("b", 8, 1)), ("concat", "s"),
            ("conv", LayerDef("dw2", 32, 3, groups=-1))]
    resolve_in_channels(plan, 3)
    assert [(op[1].in_ch, op[1].groups) for op in plan if op[0] == "conv"] == \
        [(3, 1), (24, 24), (24, 1), (32, 32)]


def test_layer_defs_match_jax():
    anchors = np.ones((5, 2), np.float32)
    jmodel = JMobileNet(anchors=anchors, num_classes=20)
    model = MobileNet(anchors=anchors, num_classes=20)
    assert _defs(model) == _defs(jmodel)
    assert len(model.layer_defs) == 1 + 26 + 5
    assert [op for op in model.plan if op[0] != "conv"] == \
        [op for op in jmodel.plan if op[0] != "conv"]


def test_config_builds_the_port_mobilenet():
    config = load_config(CONFIGS, ["model/pallas=nms fusedpost dwsep dwconv"])
    _, anchors, model = tcommon.build(config)
    assert type(model) is MobileNet and model.pallas == TOKENS
    assert model.dtype == torch.bfloat16 and model.out_channels == 125


def test_apply_folded_matches_jax(rng, jax_mobilenet):
    jmodel, params, state = jax_mobilenet
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))
    model = _port(jmodel)
    with torch.no_grad():
        got = model.apply_folded(model.fold(*from_jax(params, state)), torch.from_numpy(x))
    assert got.shape == want.shape == (2, 2, 2, 5 * 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def _spy(monkeypatch, module, name, log, kind, stride_at):
    """Wrap ``module.name`` to log (kind, input shape, stride) per call; the
    stride is positional argument ``stride_at``."""
    fn = getattr(module, name)

    def spy(*args):
        log.append((kind, tuple(args[0].shape), args[stride_at]))
        return fn(*args)

    monkeypatch.setattr(module, name, spy)


def _port_routes(monkeypatch):
    log = []
    _spy(monkeypatch, dk, "dwconv3x3", log, "dwconv", 3)
    _spy(monkeypatch, sk, "dwsep", log, "dwsep", 5)
    return log


def test_routing_at_192_matches_the_jax_engine(rng, monkeypatch, jax_mobilenet):
    jmodel, params, state = jax_mobilenet
    x = rng.uniform(0, 1, (1, 192, 192, 3)).astype(np.float32)
    jmodel = JMobileNet(anchors=jmodel.anchors, num_classes=jmodel.num_classes,
                        dtype=jnp.float32, pallas=frozenset({"dwsep", "dwconv"}))
    jlog = []
    monkeypatch.setattr(jmodels, "pallas_active", lambda which, enabled: which in enabled)
    _spy(monkeypatch, jdwconv, "dwconv3x3_pallas", jlog, "dwconv", 2)
    _spy(monkeypatch, jdwsep, "dwsep_pallas", jlog, "dwsep", 5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))

    log = _port_routes(monkeypatch)
    model = _port(jmodel, jmodel.pallas)
    with torch.no_grad():
        got = model.apply_folded(model.fold(*from_jax(params, state)), torch.from_numpy(x))
    # dw3, dw4 (input height 48 > 40) to dwconv; dw5..dw13 with their pw to dwsep
    assert [k for k, *_ in log] == ["dwconv"] * 2 + ["dwsep"] * 9
    assert log[0] == ("dwconv", (1, 48, 48, 128), 1) and log[2] == ("dwsep", (1, 24, 24, 256), 1)
    assert log == jlog
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_routing_at_416(monkeypatch):
    model = MobileNet(anchors=np.ones((5, 2), np.float32), num_classes=20,
                      dtype=torch.float32, pallas=TOKENS)
    params, state = model.init(torch.Generator().manual_seed(0))
    folded = model.fold(params, state)
    log = _port_routes(monkeypatch)
    with torch.no_grad():
        raw = model.apply_folded(folded, torch.rand(1, 416, 416, 3))
    assert raw.shape == (1, 13, 13, 125)
    assert log == [("dwconv", (1, 104, 104, 128), 1), ("dwconv", (1, 104, 104, 128), 2),
                   ("dwconv", (1, 52, 52, 256), 1), ("dwconv", (1, 52, 52, 256), 2),
                   *[("dwsep", (1, 26, 26, 512), 1)] * 5, ("dwsep", (1, 26, 26, 512), 2),
                   ("dwsep", (1, 13, 13, 1024), 1)]
    # kernel layouts only where a kernel may read them
    assert "taps" not in folded["dw2"] and "w_io" not in folded["pw2"]
    assert folded["dw3"]["taps"].shape == (3, 3, 128) and "w_io" in folded["pw3"]
    assert folded["pw13"]["w_io"].shape == (1024, 1024)


def test_fold_adds_no_kernel_layouts_without_tokens():
    model = MobileNet(anchors=np.ones((5, 2), np.float32), num_classes=20)
    folded = model.fold(*model.init(torch.Generator().manual_seed(0)))
    # no kernel's layout; the 125-wide head's weight padded to 128 (engine.padded_width)
    assert all(sorted(lp) == ["b", "w"] for name, lp in folded.items() if name != "out")
    assert sorted(folded["out"]) == ["b", "w", "w_pad"]
    assert folded["out"]["w_pad"].shape == (128, 1024, 1, 1)
    assert folded["dw7"]["w"].shape == (512, 1, 3, 3)


@pytest.mark.parametrize("pallas,threshold,topk", [(TOKENS, 0.005, 100),
                                                   (frozenset(), 0.05, 10)])
def test_detect_fn_matches_jax(rng, jax_mobilenet, pallas, threshold, topk):
    jmodel, params, state = jax_mobilenet
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jinf = JInference(jmodel)
    want = jinf.detect_fn(threshold, 0.45, topk)(jinf.fold(params, state), jnp.asarray(x))

    inference = Inference(_port(jmodel, pallas))
    got = inference.detect_fn(threshold, 0.45, topk)(inference.fold(*from_jax(params, state)),
                                                     torch.from_numpy(x))
    keep = np.asarray(want.keep)
    assert keep.any()
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(np.where(keep, got.conf.numpy(), 0),
                               np.where(keep, np.asarray(want.conf), 0), rtol=1e-4)
    for name in ("yx_min", "yx_max"):
        np.testing.assert_allclose(np.where(keep[..., None], getattr(got, name).numpy(), 0),
                                   np.where(keep[..., None], np.asarray(getattr(want, name)), 0),
                                   atol=1e-4, err_msg=name)


def test_detect_image_matches_jax(rng):
    config = load_config(CONFIGS, ["model/pallas=nms fusedpost dwsep dwconv",
                                   "model/dtype=float32", "data/canvas=96",
                                   "detect/threshold=0.02"])
    image = rng.integers(0, 255, (60, 80, 3), dtype=np.uint8)
    _, _, jmodel = jcommon.build(config)
    params, state = _randomize_bn(rng, *jmodel.init(jax.random.PRNGKey(2)))
    want = jdetect.detect_image(config, jmodel, params, state, image, 64)

    _, _, model = tcommon.build(config)
    got = tdetect.detect_image(config, model, *from_jax(params, state), image, 64)
    assert len(want[2]) > 0
    np.testing.assert_array_equal(got[2], want[2])                      # classes
    np.testing.assert_allclose(got[3], want[3], rtol=1e-4)              # conf
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)              # yx_min
    np.testing.assert_allclose(got[1], want[1], atol=1e-4)              # yx_max


def test_checkpoint_loads_jax_mobilenet_npz(rng, tmp_path):
    config = load_config(CONFIGS, ["model/dtype=float32"])
    _, _, jmodel = jcommon.build(config)
    params, state = _randomize_bn(rng, *jmodel.init(jax.random.PRNGKey(4)))
    path = str(tmp_path / "12.npz")
    jckpt.save(path, {"params": params, "state": state}, {"step": 12})

    _, _, model = tcommon.build(config)
    tp, ts, meta = tcommon.load_weights_auto(config, model, path)
    assert meta["step"] == 12
    assert params["dw5"]["w"].shape == (3, 3, 1, 256) and tp["dw5"]["w"].shape == (256, 1, 3, 3)
    np.testing.assert_array_equal(tp["dw5"]["w"].numpy(),
                                  params["dw5"]["w"].transpose(3, 2, 0, 1))
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))
    with torch.no_grad():
        got = model.apply_folded(model.fold(tp, ts), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
