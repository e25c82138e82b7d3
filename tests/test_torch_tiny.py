"""Port parity, the Tiny-YOLO-VOC detect slice: yolojax_torch's ``Tiny``
against yolojax's on the CPU, in f32, at full width (the pool gate reads the
real channel counts), with weights carried over by ``checkpoint.from_jax``.

The JAX engine runs the 2×2/2 pool kernel on pool4 and pool5 (``pallas =
... pool``), the port on pool1-pool5 with their convs' epilogues (its conv →
pool route, whatever the tokens); the stride-1 tail pool is SAME: -inf padding on the bottom and right, so
the 13×13 grid stays 13×13 at 416 (a VALID pool would give 12×12).
Tolerances: pools exact; raw heads rtol/atol 1e-3 (test_torch_mobilenet.py's
bound: 9 convolutions summed in other orders); the fused postprocess fed one
raw head ``keep`` identical, conf and corners atol 1e-5; detect end to end
``keep`` exact, conf and corners atol 1e-4, as test_torch_inference.py holds
Darknet.  The JAX pool kernel runs in interpret mode.
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
import yolojax.kernels.pool as jpool
import yolojax.models as jmodels
from yolojax.category import get_anchors
from yolojax.kernels.nms import postprocess_fused_pallas
from yolojax.models import blocks as jblocks
from yolojax.models.darknet import Tiny as JTiny
from yolojax.models.inference import Inference as JInference
from yolojax.utils import checkpoint as jckpt
from yolojax_torch.cli import common as tcommon
from yolojax_torch.cli import detect as tdetect
from yolojax_torch.config import load_config
from yolojax_torch.kernels import pool as pk
from yolojax_torch.kernels.postprocess_fused import postprocess_fused
from yolojax_torch.models import blocks
from yolojax_torch.models.darknet import Tiny
from yolojax_torch.models.inference import Inference
from yolojax_torch.utils.checkpoint import from_jax

TOKENS = frozenset({"nms", "fusedpost", "pool"})
REPO = Path(__file__).resolve().parents[1]
CONFIGS = [str(REPO / "config.ini"), str(REPO / "config" / "tiny.ini")]


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


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


@pytest.fixture(scope="module")
def jax_tiny():
    """Full-width JAX Tiny (4 classes) with randomized BN statistics."""
    rng = np.random.default_rng(13)
    anchors = rng.uniform(0.5, 3.0, (5, 2)).astype(np.float32)
    model = JTiny(anchors=anchors, num_classes=4, dtype=jnp.float32, pallas=TOKENS)
    params, state = _randomize_bn(rng, *model.init(jax.random.PRNGKey(6)))
    return model, params, state


def _port(jmodel):
    return Tiny(anchors=jmodel.anchors, num_classes=jmodel.num_classes, dtype=torch.float32,
                pallas=jmodel.pallas)


def _defs(model):
    return [(d.name, d.in_ch, d.out_ch, d.ksize, d.groups, d.stride, d.bn, d.act)
            for d in model.layer_defs]


def _spy(monkeypatch, module, name, log):
    fn = getattr(module, name)

    def spy(x, *args):
        log.append(tuple(x.shape))
        return fn(x, *args)

    monkeypatch.setattr(module, name, spy)


def test_plan_matches_jax():
    anchors = np.ones((5, 2), np.float32)
    jmodel, model = JTiny(anchors=anchors, num_classes=20), Tiny(anchors=anchors, num_classes=20)
    assert _defs(model) == _defs(jmodel) and len(model.layer_defs) == 9
    assert [op for op in model.plan if op[0] != "conv"] == \
        [op for op in jmodel.plan if op[0] != "conv"]


def test_config_builds_the_port_tiny():
    config = load_config(CONFIGS, ["model/pallas=nms fusedpost pool"])
    _, anchors, model = tcommon.build(config)
    assert type(model) is Tiny and model.pallas == TOKENS
    assert model.dtype == torch.bfloat16 and model.out_channels == 125
    np.testing.assert_array_equal(model.anchors, get_anchors(config))
    assert config.get("model", "anchors").endswith("tiny-voc.tsv")


@pytest.mark.parametrize("shape,size,stride", [
    ((1, 13, 13, 8), 2, 1),        # Tiny's tail pool at 416: 13×13 stays 13×13
    ((2, 4, 6, 3), 2, 1),
    ((2, 5, 7, 3), 3, 1),          # SAME with one row before and one after
    ((2, 13, 13, 4), 2, 2),        # VALID: 13 → 6
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_matches_jax(rng, shape, size, stride, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jblocks.max_pool(jnp.asarray(x, getattr(jnp, dtype)), size, stride),
                      np.float32)
    got = blocks.max_pool(torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2),
                          size, stride).permute(0, 2, 3, 1)
    if stride == 1:
        assert got.shape == shape
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_routing_and_raw_head_at_64_match_the_jax_engine(rng, monkeypatch, jax_tiny):
    jmodel, params, state = jax_tiny
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jlog = []
    monkeypatch.setattr(jmodels, "pallas_active", lambda which, enabled: which in enabled)
    _spy(monkeypatch, jpool, "maxpool2x2_pallas", jlog)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))

    log = []
    _spy(monkeypatch, pk, "maxpool2x2", log)
    model = _port(jmodel)
    with torch.no_grad():
        got = model.apply_folded(model.fold(*from_jax(params, state)), torch.from_numpy(x))
    # the JAX engine routes pool4 and pool5 (C 128, 256), not pool1-pool3 (C 16-64);
    # the port's conv → 2×2/2 pairs all take the pool kernel; the stride-1 pool neither
    assert jlog == [(2, 8, 8, 128), (2, 4, 4, 256)]
    assert log == [(2, 64, 64, 16), (2, 32, 32, 32), (2, 16, 16, 64)] + jlog
    assert got.shape == want.shape == (2, 2, 2, 45)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_routing_and_grid_at_416(monkeypatch):
    model = Tiny(anchors=np.ones((5, 2), np.float32), num_classes=20, dtype=torch.float32,
                 pallas=TOKENS)
    folded = model.fold(*model.init(torch.Generator().manual_seed(0)))
    log = []
    _spy(monkeypatch, pk, "maxpool2x2", log)
    with torch.no_grad():
        raw = model.apply_folded(folded, torch.rand(1, 416, 416, 3))
    assert raw.shape == (1, 13, 13, 125)
    assert log == [(1, 416, 416, 16), (1, 208, 208, 32), (1, 104, 104, 64), (1, 52, 52, 128),
                   (1, 26, 26, 256)]


def test_postprocess_of_one_raw_head_matches_jax(rng, jax_tiny):
    """detect_fn's fused path fed the JAX forward's raw head on both sides."""
    jmodel, params, state = jax_tiny
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    raw = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))
    with pltpu.force_tpu_interpret_mode():
        want = postprocess_fused_pallas(jnp.asarray(raw), jmodel.anchors, 0.005, 0.45, 100)
    got = postprocess_fused(torch.tensor(raw), jmodel.anchors, 0.005, 0.45, 100)
    keep = np.asarray(want.keep)
    assert keep.any()
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    for name in ("conf", "yx_min", "yx_max"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        m = keep if name == "conf" else keep[..., None]
        np.testing.assert_allclose(np.where(m, g, 0), np.where(m, w, 0), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_detect_fn_matches_jax(rng, monkeypatch, jax_tiny):
    jmodel, params, state = jax_tiny
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    monkeypatch.setattr(jmodels, "pallas_active", lambda which, enabled: which in enabled)
    jinf = JInference(jmodel)
    with pltpu.force_tpu_interpret_mode():
        want = jinf.detect_fn(0.005, 0.45, 100)(jinf.fold(params, state), jnp.asarray(x))

    inference = Inference(_port(jmodel))
    got = inference.detect_fn(0.005, 0.45, 100)(inference.fold(*from_jax(params, state)),
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
    config = load_config(CONFIGS, ["model/pallas=nms fusedpost pool", "model/dtype=float32",
                                   "data/canvas=96", "detect/threshold=0.02"])
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


def test_checkpoint_loads_jax_tiny_npz(rng, tmp_path):
    config = load_config(CONFIGS, ["model/dtype=float32"])
    _, _, jmodel = jcommon.build(config)
    params, state = _randomize_bn(rng, *jmodel.init(jax.random.PRNGKey(4)))
    path = str(tmp_path / "7.npz")
    jckpt.save(path, {"params": params, "state": state}, {"step": 7})

    _, _, model = tcommon.build(config)
    tp, ts, meta = tcommon.load_weights_auto(config, model, path)
    assert meta["step"] == 7 and sorted(tp) == sorted(params)
    np.testing.assert_array_equal(tp["c7"]["w"].numpy(), params["c7"]["w"].transpose(3, 2, 0, 1))
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))
    with torch.no_grad():
        got = model.apply_folded(model.fold(tp, ts), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
