"""Port parity, the detect slice as a whole: yolojax_torch against yolojax on
the CPU, in f32, on a narrow Darknet at 64² with weights carried over by
``checkpoint.from_jax``.

Tolerances: ``keep`` exact and conf rtol 1e-4 for detect (the raw heads
agree to ~1e-5 after 23 convolutions summed in different orders; picks are
discrete); the resize atol 1e-5 (both build the same weight matrices, the
contraction order differs); boxes atol 1e-4 after the resize inversion.
Also checks that the port and the yolojax modules it reuses import no jax.
"""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolojax.cli.common as jcommon
import yolojax.cli.detect as jdetect
from yolojax.data import transform as jtransform
from yolojax.models import ChannelResolver as JChannelResolver
from yolojax.models.darknet import Darknet as JDarknet
from yolojax.models.inference import Inference as JInference
from yolojax_torch.cli import common as tcommon
from yolojax_torch.cli import detect as tdetect
from yolojax_torch.config import load_config
from yolojax_torch.data import transform as ttransform
from yolojax_torch.kernels.postprocess_fused import postprocess_fused
from yolojax_torch.models import ChannelResolver
from yolojax_torch.models.darknet import Darknet
from yolojax_torch.models.inference import Inference
from yolojax_torch.utils.checkpoint import from_jax

REPO = Path(__file__).resolve().parents[1]
NARROW = {"c1": 8, "c2": 8, "c3": 16, "c4": 8, "c5": 16, "c6": 16, "c7": 8, "c8": 16,
          "c9": 32, "c10": 16, "c11": 32, "c12": 16, "c13": 32, "c14": 32, "c15": 16,
          "c16": 32, "c17": 16, "c18": 32, "c19": 32, "c20": 32, "c21": 8, "c22": 32}


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


@pytest.mark.parametrize("pallas,threshold,topk", [
    (frozenset({"nms", "fusedpost"}), 0.005, 100),   # the default config's tokens
    (frozenset(), 0.05, 10),
])
def test_detect_fn_matches_jax(rng, pallas, threshold, topk):
    anchors = rng.uniform(0.5, 3.0, (5, 2)).astype(np.float32)
    jmodel = JDarknet(anchors=anchors, num_classes=4, dtype=jnp.float32,
                      width=JChannelResolver(NARROW))
    params, state = _randomize_bn(rng, *jmodel.init(jax.random.PRNGKey(1)))
    x = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    jinf = JInference(jmodel)
    want = jinf.detect_fn(threshold, 0.45, topk)(jinf.fold(params, state), jnp.asarray(x))

    model = Darknet(anchors=anchors, num_classes=4, dtype=torch.float32,
                    width=ChannelResolver(NARROW), pallas=pallas)
    inference = Inference(model)
    launches = postprocess_fused.launches
    got = inference.detect_fn(threshold, 0.45, topk)(inference.fold(*from_jax(params, state)),
                                                     torch.from_numpy(x))
    assert postprocess_fused.launches == launches    # CPU tensors: plain version
    keep = np.asarray(want.keep)
    assert keep.any()
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(np.where(keep, got.conf.numpy(), 0),
                               np.where(keep, np.asarray(want.conf), 0), rtol=1e-4)
    for name in ("yx_min", "yx_max"):
        np.testing.assert_allclose(np.where(keep[..., None], getattr(got, name).numpy(), 0),
                                   np.where(keep[..., None], np.asarray(getattr(want, name)), 0),
                                   atol=1e-4, err_msg=name)


def _canvas(rng, c, h, w):
    canvas = np.full((c, c, 3), 127, np.uint8)
    oy, ox = (c - h) // 2, (c - w) // 2
    canvas[oy:oy + h, ox:ox + w] = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    return canvas, np.asarray([h, w], np.float32)


@pytest.mark.parametrize("name", ["stretch_batch", "letterbox_batch"])
@pytest.mark.parametrize("c,hws,size", [
    (64, [(40, 48), (64, 20)], 32),    # downscale: antialiased, widened kernel
    (48, [(30, 48), (17, 9)], 80),     # upscale
])
def test_resize_matches_jax(rng, name, c, hws, size):
    canvases, hw = zip(*(_canvas(rng, c, h, w) for h, w in hws))
    canvas, hw = np.stack(canvases), np.stack(hw)
    want = getattr(jtransform, name)(canvas, hw, size)
    got = getattr(ttransform, name)(torch.from_numpy(canvas), torch.from_numpy(hw), size)
    assert got[0].shape == (len(hws), size, size, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_resize_from_config_resolves_to_the_port():
    config = load_config(None, ["transform/resize=yolojax.data.transform.letterbox"])
    assert ttransform.resize_from_config(config) is ttransform.letterbox_batch


def test_detect_image_matches_jax(rng, tmp_path):
    overlay = tmp_path / "narrow.json"
    overlay.write_text(json.dumps(NARROW))
    config = load_config(None, [f"model/channels={overlay}", "model/dtype=float32",
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


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


# the yolojax modules the port reuses unchanged
REUSED = ["yolojax/__init__.py", "yolojax/config.py", "yolojax/category.py",
          "yolojax/utils/__init__.py", "yolojax/utils/visualize.py", "yolojax/cli/__init__.py"]


def test_port_imports_no_jax():
    files = sorted((REPO / "yolojax_torch").rglob("*.py"))
    files += [REPO / p for p in REUSED] + [REPO / "chip_smoke.py"]
    reused = {p[:-len(".py")].replace("/", ".").removesuffix(".__init__") for p in REUSED}
    assert len(files) > len(REUSED) + 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax"), f"{path} imports {name}"
            if top == "yolojax":
                assert name in reused, f"{path} imports {name}, which is not jax-free"
