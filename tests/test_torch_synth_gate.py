"""The port's synthetic accuracy gate (``yolojax_torch/tools/synth_gate.py``)
against the JAX package's (``scripts/synth_gate.py``, loaded by path: its
module top needs only numpy and ``yolojax.data.synth``).

* the logic: the frozen criteria and their history, ``criteria_for`` for
  every model at 8 and 80 classes, ``adjudicate`` on 400 seeded random
  grids, on grids that sit on each boundary and on the five committed JAX
  artifacts (each re-adjudicated to its recorded ``pass``), ``write_overlay``'s
  text for each model and format, the artifact's name;
* the data: the two generators write byte-identical images and annotations
  from one seed; where OpenCV is missing, ``data/synth.py::Raster`` paints
  the same shapes from the same draws (the same annotations; at most 1 % of
  an image's pixels differ, at the shapes' edges) and writes binary PPM,
  which ``data/dataset.py`` decodes to what cv2 decodes;
* the chain on the CPU with OpenCV hidden, as on a card machine without
  it: Tiny, 12 images, the gate's overlay and a test overlay (f32,
  batch 2 (6 train images), sizes 64, multi-scale 64–96, 4 steps, no
  device dataset, eval batch 6).
  The canvas stays the gate's 672: the images are 330–560 pixels, and a
  smaller canvas downscales them on the host through cv2.  Every stage
  exits 0, the grid holds 8 finite mAPs in [0, 1], the COCO block is there
  and the criteria are ``criteria_for("tiny")``;
* that run's checkpoint through the JAX package's ``run_eval`` and the
  port's at 64 and 96 × stretch and letterbox, f32: the mAPs agree to 1e-6;
* ``--skip-train`` keeps an artifact's train block and appends a dated
  ``reevals`` entry, ``--readjudicate`` too, and the gate refuses to run
  on ``--device cuda`` where there is no card.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yolojax_torch.data import synth
from yolojax_torch.data.dataset import _imread_rgb
from yolojax_torch.tools import synth_gate as gate

from torch_port_families import one_thread

ROOT = Path(__file__).resolve().parents[1]
ARTIFACTS = ["SYNTH_GATE.json", "SYNTH_GATE_TINY.json", "SYNTH_GATE_MOBILENET.json",
             "SYNTH_GATE_COCO.json", "SYNTH_GATE_COCO80.json"]
KEYS = [f"{m}_{s}" for m in gate.MODES for s in gate.SIZES]


def _reference():
    spec = importlib.util.spec_from_file_location("jax_synth_gate",
                                                  ROOT / "scripts" / "synth_gate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference()


def test_frozen_tables_equal_the_reference():
    for name in ("CRITERIA", "TINY_MAP_FACTOR", "COCO80_MAP_FACTOR", "SMALL_SIZE_ERR_RATIO",
                 "ACCURACY_FLOORS", "CRITERIA_HISTORY", "MODELS"):
        assert getattr(gate, name) == getattr(REF, name), name


@pytest.mark.parametrize("classes", [8, 80])
@pytest.mark.parametrize("model", sorted(gate.MODELS))
def test_criteria_for_equals_the_reference(model, classes):
    assert gate.criteria_for(model, classes) == REF.criteria_for(model, classes)


def _grid(rng, lo: float, hi: float) -> tuple[dict, dict]:
    return ({k: float(rng.uniform(lo, hi)) for k in KEYS},
            {"ap": float(rng.uniform(lo - 0.4, hi - 0.4)), "ap50": 0.0, "ap75": 0.0})


@pytest.mark.parametrize("span", [(0.0, 1.0), (0.75, 0.97), (0.85, 0.93)])
def test_adjudicate_equals_the_reference_on_random_grids(span):
    rng = np.random.default_rng(int(span[0] * 100))
    passes = set()
    for i in range(400 // 3 + 1):
        results, coco = _grid(rng, *span)
        model = sorted(gate.MODELS)[i % 3]
        crit = gate.criteria_for(model, (8, 80)[i % 2])
        got = gate.adjudicate(results, coco, crit)
        assert got == REF.adjudicate(results, coco, crit), (results, coco)
        passes.add(got[0])
    if span != (0.0, 1.0):
        assert passes == {True, False}     # both outcomes were reached


def _boundary_cases():
    """A passing grid, then each criterion set exactly on its bound and one
    step past it."""
    crit = gate.criteria_for("darknet")
    base = {f"stretch_{s}": v for s, v in zip(gate.SIZES, (0.85, 0.9, 0.93, 0.94))}
    base.update({f"letterbox_{s}": base[f"stretch_{s}"] for s in gate.SIZES})
    coco = {"ap": 0.6, "ap50": 0.9, "ap75": 0.6}
    cases = []
    for key, floor in (("stretch_416", "min_map_416"), ("stretch_544", "min_map_544_608"),
                       ("stretch_608", "min_map_544_608"), ("stretch_320", "min_map_320")):
        for delta in (0.0, -1e-4):
            cases.append(({**base, key: crit[floor] + delta}, coco))
    for delta in (0.0, -1e-4):
        cases.append((base, {**coco, "ap": crit["min_coco_ap_416"] + delta}))
    for delta in (0.0, 1e-4):
        cases.append(({**base, "letterbox_416": base["stretch_416"] - crit["max_lb_delta"]
                       - delta}, coco))
    best = 0.94
    for drop in (crit["max_small_size_drop"], crit["max_small_size_drop"] + 1e-4):
        cases.append(({**base, "stretch_320": best * (1 - drop)}, coco))
    return cases


@pytest.mark.parametrize("case", range(len(_boundary_cases())))
def test_adjudicate_equals_the_reference_on_each_boundary(case):
    results, coco = _boundary_cases()[case]
    for model in gate.MODELS:
        crit = gate.criteria_for(model)
        assert gate.adjudicate(results, coco, crit) == REF.adjudicate(results, coco, crit)


@pytest.mark.parametrize("name", ARTIFACTS)
def test_the_committed_jax_artifacts_readjudicate_to_their_pass(name):
    art = json.loads((ROOT / name).read_text())
    crit = gate.criteria_for(art["train"]["model"], int(art["train"].get("num_classes", 8)))
    ok, derived = gate.adjudicate(art["map"], art["coco_ap_416_stretch"], crit)
    assert (ok, derived) == REF.adjudicate(art["map"], art["coco_ap_416_stretch"], crit)
    assert ok == art["pass"]
    # an artifact adjudicated before the err-ratio arm (r5b) records no such key
    assert {k: crit[k] for k in art["criteria"]} == art["criteria"]


@pytest.mark.parametrize("fmt,classes", [("voc", 8), ("coco", 8), ("coco", 80)])
@pytest.mark.parametrize("model", sorted(gate.MODELS))
def test_write_overlay_and_the_artifact_name_equal_the_reference(tmp_path, model, fmt, classes):
    names, _ = synth.make_classes(classes)
    texts = []
    for module in (gate, REF):
        path = module.write_overlay(str(tmp_path), "/data/synth", 6000, fmt=fmt, model=model,
                                    classes=names)
        texts.append((Path(path).read_text(),
                      (tmp_path / f"category{classes}").read_text()))
    assert texts[0] == texts[1]
    tag = gate.artifact_name(model, fmt, classes)
    assert tag.startswith("SYNTH_GATE_TORCH") and tag.endswith(".json")


@pytest.mark.parametrize("fmt", ["voc", "coco"])
def test_the_generators_write_the_reference_bytes(tmp_path, fmt):
    from yolojax.data import synth as jsynth

    for side, module in (("port", synth), ("jax", jsynth)):
        if fmt == "voc":
            module.generate_voc(str(tmp_path / side), n_images=6, seed=3)
        else:
            module.generate_coco(str(tmp_path / side), n_images=6, seed=3, num_classes=80,
                                 crowd_frac=0.03)
    files = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                   if p.is_file())
    assert len(files) >= 8
    assert files == sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                           if p.is_file())
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_the_raster_paints_what_cv2_paints(monkeypatch):
    classes, colors = synth.make_classes(80)
    for i in range(40):
        drawn = []
        for painter in (synth.painter(), synth.Raster()):
            monkeypatch.setattr(synth, "painter", lambda p=painter: p)
            drawn.append(synth._gen_image(np.random.default_rng(i), classes, colors, 0.45))
        (cv, objs, h, w), (raster, robjs, rh, rw) = drawn
        assert (objs, h, w) == (robjs, rh, rw)
        assert np.mean(np.any(cv != raster, axis=-1)) <= 0.01


def test_a_ppm_reads_as_cv2_reads_it(tmp_path):
    import cv2

    img = np.random.default_rng(0).integers(0, 256, (33, 47, 3), dtype=np.uint8)
    path = str(tmp_path / "x.jpg")
    assert synth.Raster.imwrite(path, img[:, :, ::-1])
    np.testing.assert_array_equal(_imread_rgb(path), img)
    np.testing.assert_array_equal(cv2.imread(path)[:, :, ::-1], img)


TEST_OVERLAY = """[model]
dtype = float32
[data]
batch_size = 2
sizes = 64,64
device_dataset = 0
workers = 2
[train]
multi_scale_min = 64
multi_scale_max = 96
multi_scale_interval = 2
prewarm = 0
[transform]
dtype = float32
[eval]
batch_size = 6
"""


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The gate's chain on the CPU with OpenCV hidden from this process and
    from the train subprocess, torch on one thread in both."""
    root = tmp_path_factory.mktemp("gate")
    hidden = root / "no_cv2"
    hidden.mkdir()
    (hidden / "cv2.py").write_text("raise ImportError('OpenCV is hidden by the test')\n")
    overlay = root / "test.ini"
    overlay.write_text(TEST_OVERLAY)
    out = root / "artifact.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "cv2", None)
        mp.setenv("PYTHONPATH", os.pathsep.join([str(hidden), os.environ.get("PYTHONPATH", "")]))
        with one_thread(mp):
            rc = gate.main(["--root", str(root / "ws"), "--model", "tiny", "--images", "12",
                            "--steps", "4", "--device", "cpu", "--out", str(out)],
                           extra_cfg=[str(overlay)])
    return root, rc, json.loads(out.read_text())


def test_the_chain_runs_on_the_cpu_without_opencv(chain):
    root, rc, art = chain
    assert rc in (0, 1)                                   # a pass or a fail, no kernel gap
    assert sorted(art["map"]) == sorted(KEYS)
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in art["map"].values())
    assert set(art["coco_ap_416_stretch"]) == {"ap", "ap50", "ap75"}
    assert art["criteria"] == gate.criteria_for("tiny") == REF.criteria_for("tiny")
    assert art["pass"] == gate.adjudicate(art["map"], art["coco_ap_416_stretch"],
                                          art["criteria"])[0]
    assert art["train"]["step"] == 4 and art["train"]["model"] == "tiny"
    assert art["dataset"]["codec"].startswith("ppm")
    assert art["device"]["device"] == "cpu" and art["device"]["dtype"] == "float32"
    assert art["kernel_evals"]["stretch_416"]["agrees"]
    ws = root / "ws"
    assert (ws / "VOC2007" / "JPEGImages" / "000000.jpg").read_bytes().startswith(b"P6")
    assert not (ws / "anchors.tsv").exists()              # Tiny keeps its shipped anchors


def test_one_checkpoint_evaluates_to_the_reference_grid(chain):
    """The chain's checkpoint through both packages' ``run_eval``: the same
    mAP at 64 and 96 × stretch and letterbox, f32."""
    from yolojax import cli as jcli
    from yolojax.cli.common import build as jbuild
    from yolojax.cli.common import load_weights_auto as jload
    from yolojax.cli.eval import run_eval as jrun_eval
    from yolojax.data.cache import load_cache as jload_cache
    from yolojax_torch import cli
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.eval import run_eval
    from yolojax_torch.data.cache import load_cache

    root, _, _ = chain
    cfg = ["-c", str(ROOT / "config.ini"), str(ROOT / "config" / "tiny.ini"),
           str(root / "ws" / "gate.ini"), str(root / "test.ini")]
    jconfig = jcli.setup(jcli.make_parser("eval").parse_args(cfg))
    config = cli.setup(cli.make_parser("eval").parse_args(cfg))
    jcategory, _, jmodel = jbuild(jconfig)
    category, _, model = build(config)
    jparams, jstate, jmeta = jload(jconfig, jmodel, None, resume=True)
    params, state, meta = load_weights_auto(config, model, None, resume=True)
    assert jmeta["step"] == meta["step"] == 4
    jrecords, records = jload_cache(jconfig, "test"), load_cache(config, "test")
    found = 0
    for mode in gate.MODES:
        for c in (jconfig, config):
            c.set("transform", "resize", f"yolojax.data.transform.{mode}")
        for size in (64, 96):
            want = jrun_eval(jconfig, jmodel, jparams, jstate, jrecords, size, 6, jcategory)
            got = run_eval(config, model, params, state, records, size, 6, category)
            assert abs(got["map"] - want["map"]) <= 1e-6, (mode, size, got["map"], want["map"])
            found += sum(len(d) for d in got["recorder"].dets.values())
    assert found


def test_skip_train_and_readjudicate_append_to_the_artifact(chain, tmp_path, monkeypatch):
    _, _, art = chain
    path = tmp_path / "a.json"
    path.write_text(json.dumps({**art, "train": {**art["train"], "wall_s": 123.4}}))
    again = {**art, "train": {**art["train"], "wall_s": None}}
    gate.finish(again, str(path), skip_train=True)
    got = json.loads(path.read_text())
    assert got["train"]["wall_s"] == 123.4 and len(got["reevals"]) == 1
    monkeypatch.setattr(gate, "REPO", str(tmp_path))
    assert gate.main(["--readjudicate", "a.json"]) == (0 if art["pass"] else 1)
    got = json.loads(path.read_text())
    assert [e.get("kind") for e in got["reevals"]] == [None, "criteria-only"]
    assert got["train"]["wall_s"] == 123.4


def test_the_gate_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gate.run_gate([], root=str(tmp_path), model="tiny", fmt="voc", classes=8, steps=1)
