"""Port parity, the tools: ``cli/demo_data.py``, ``cli/demo_graph.py``,
``cli/receptive_field.py`` and ``entry.py`` against their ``yolojax``
counterparts on the CPU (f32 at 64² unless said).

Tolerances: ``demo_data`` with the augmentation off (``[transform] train``
empty, f32 pixels) is deterministic in both packages: images atol 1e-5 (the
same resize matrices contracted in another order), boxes atol 1e-6;
``plan_to_dot`` letter for letter; the receptive-field gradient map atol
1e-4 and the support box exact, on the same weights (a backward through 9
convolutions in f32); ``entry()`` draws its weights
from a ``torch.Generator``, so against ``__graft_entry__.entry`` it matches
the structure (layers, shapes, dtypes, the example batch, the outputs'
shapes), not the values.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolojax.cli.common as jcommon
from yolojax.cli import demo_data as jdemo_data
from yolojax.cli import demo_graph as jdemo_graph
from yolojax.cli.receptive_field import receptive_field as jreceptive_field
from yolojax.config import get_canvas
from yolojax.data.cache import load_cache as jload_cache
from yolojax.data.dataset import Dataset as JDataset
from yolojax.data.loader import Loader as JLoader
from yolojax.data.transform import TrainAugment as JTrainAugment
from yolojax_torch.cli import demo_data, demo_graph, receptive_field
from yolojax_torch.cli.cache import main as cache_main
from yolojax_torch.config import load_config
from yolojax_torch.data.synth import CLASSES, generate_voc
from yolojax_torch.cli.common import build as tbuild
from yolojax_torch.entry import entry, flagship

from torch_port_families import FAMILIES, ROOT, both, family_config, narrow_config


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    data = generate_voc(str(root / "data"), 8, seed=5)
    (root / "cat8").write_text("\n".join(CLASSES))
    (root / "anchors.tsv").write_text("1.0\t1.0\n2.5\t2.5\n")
    overlay = root / "ws.ini"
    overlay.write_text(f"[config]\nroot = {root}/art\n[cache]\ncategory = {root}/cat8\n"
                       f"datasets = yolojax.data.voc\nvoc_roots = {data}\n[model]\n"
                       f"dnn = yolojax.models.darknet.Tiny\nanchors = {root}/anchors.tsv\n"
                       "dtype = float32\n[data]\ncanvas = 160\nsizes = 64,64\nworkers = 2\n")
    cfg = ["-c", str(ROOT / "config.ini"), str(overlay)]
    assert cache_main(cfg + ["-p", "train"]) == 0
    return root, cfg


def test_demo_data_samples_match_jax_without_augmentation(workspace):
    _, cfg = workspace
    config = load_config(cfg[1:], ["transform/train=", "transform/dtype=float32"])
    images, boxes = demo_data.samples(config, 4, 64, seed=3, device="cpu")

    dataset = JDataset(jload_cache(config, "train"), canvas=get_canvas(config),
                       max_boxes=config.getint("data", "max_boxes", fallback=60))
    batch = next(iter(JLoader(dataset, batch_size=4, seed=3).epoch()))
    want, bmin, bmax, bvalid = JTrainAugment.from_config(config)(
        jax.random.PRNGKey(3), batch["canvas"], batch["hw"], batch["yx_min"], batch["yx_max"],
        batch["valid"], 64)
    assert images.shape == (4, 64, 64, 3) and images.dtype == np.float32
    np.testing.assert_allclose(images, np.asarray(want), atol=1e-5)
    for b, (ymin, ymax, cls) in enumerate(boxes):
        v = np.asarray(bvalid[b])
        assert v.any()
        np.testing.assert_allclose(ymin, np.asarray(bmin[b])[v], atol=1e-6)
        np.testing.assert_allclose(ymax, np.asarray(bmax[b])[v], atol=1e-6)
        np.testing.assert_array_equal(cls, np.asarray(batch["cls"][b])[v])


def test_demo_data_cli_writes_one_image_per_sample_as_jax_does(workspace, tmp_path):
    _, cfg = workspace
    config = load_config(cfg[1:])
    images, boxes = demo_data.samples(config, 3, 64, seed=0, device="cpu")
    assert images.shape == (3, 64, 64, 3) and np.isfinite(images).all()
    for ymin, ymax, cls in boxes:     # augmented boxes stay inside the image
        assert len(cls) and (ymin >= 0).all() and (ymax <= 1).all() and (ymin <= ymax).all()
    assert demo_data.main(cfg + ["-n", "3", "--size", "64", "--device", "cpu", "-o",
                                 str(tmp_path / "port")]) == 0
    assert jdemo_data.main(cfg + ["-n", "3", "--size", "64", "-o", str(tmp_path / "jax")]) == 0
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax")) == [
        f"sample{i}.png" for i in range(3)]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plan_to_dot_is_the_reference_text(family):
    config = family_config(family)
    _, _, jmodel = jcommon.build(config)
    _, _, model = tbuild(config)
    assert demo_graph.plan_to_dot(model) == jdemo_graph.plan_to_dot(jmodel)


def test_demo_graph_cli(workspace, tmp_path):
    _, cfg = workspace
    out = tmp_path / "graph"
    assert demo_graph.main(cfg + ["-m", "model/pallas=nms fusedpost pool", "--size", "64",
                                  "--device", "cpu", "-o", str(out)]) == 0
    _, _, jmodel = jcommon.build(load_config(cfg[1:]))
    assert (out / "plan.dot").read_text() == jdemo_graph.plan_to_dot(jmodel)
    text, code = (out / "model.graph.txt").read_text(), (out / "model.fx.py").read_text()
    # Tiny's five conv → 2×2/2 pools are custom-op calls in the program
    assert text.count("yolojax_torch.maxpool2x2.default(") == 5
    assert "def forward" in code and code.count("yolojax_torch.maxpool2x2") == 5


def test_receptive_field_matches_jax(rng):
    """Tiny's plan (its stride-1 SAME pool included) at narrow widths: the
    support is the plan's, and the JAX package compiles the backward."""
    jmodel, (jp, js), model, (p, s) = both(narrow_config("tiny"), rng)
    g, support, eff = receptive_field.receptive_field(model, p, s, 64)
    jg, jsupport, jeff = jreceptive_field(jmodel, jax.tree_util.tree_map(jnp.asarray, jp),
                                          jax.tree_util.tree_map(jnp.asarray, js), 64)
    assert support == jsupport and support is not None
    np.testing.assert_allclose(g, jg, atol=1e-4)
    assert eff == pytest.approx(jeff, rel=1e-4)


def test_receptive_field_cli(workspace, capsys):
    _, cfg = workspace
    assert receptive_field.main(cfg + ["--size", "64", "--device", "cpu"]) == 0
    assert "support=" in capsys.readouterr().out


def test_entry_matches_the_reference_structure():
    """The reference's flagship model (``__graft_entry__._flagship``): the
    same layers, widths and dtypes; its example batch; the outputs of one
    small batch."""
    import __graft_entry__

    fn, (folded, images) = entry(device="cpu")
    jmodel = __graft_entry__._flagship()
    assert [d.name for d in jmodel.layer_defs] == list(folded)
    for d in jmodel.layer_defs:
        assert tuple(folded[d.name]["w"].shape) == (d.out_ch, d.in_ch // d.groups, d.ksize,
                                                   d.ksize)
        assert folded[d.name]["w"].dtype == torch.bfloat16 and folded[d.name]["b"].dtype == \
            torch.float32
    assert str(jnp.dtype(jmodel.dtype)) == "bfloat16" and jmodel.pallas == {"nms", "fusedpost"}
    np.testing.assert_array_equal(np.asarray(jmodel.anchors), flagship().anchors)
    assert tuple(images.shape) == (8, 416, 416, 3) and images.dtype == torch.float32
    assert images.device.type == "cpu" and not images.any()
    out = fn(folded, torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(0)))
    assert tuple(out.conf.shape) == (1, 20, 100) and tuple(out.yx_min.shape) == (1, 20, 100, 2)
    assert all(t.device.type == "cpu" for t in out)
    assert all(torch.isfinite(t).all() for t in out[:3])
