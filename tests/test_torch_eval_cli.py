"""The port's eval path against ``yolojax``'s on the CPU: ``cli/eval.py``'s
``run_eval`` and ``main``.

Full-width Darknet-19 in f32 at 64² (a 2×2 grid), on synthetic workspaces
written by ``yolojax.data.synth`` (8 shape classes): VOC for the VOC
protocol, COCO (crowd boxes included) for AP@[.5:.95].  The cache is built
by the port's cache CLI and the anchors by its estimate CLI at 64² (the
config's VOC anchors span more than the whole 2×2 grid, so no box could
match).  The weights are the JAX package's seeded init with randomized BN
statistics, handed to the port through ``utils/checkpoint.py::from_jax``.
Eval runs at ``[eval]``'s own point (threshold 0.005, topk 300).

Bounds: mAP within 1e-4 and each class's AP within 1e-3 of the reference.
Both run f32 convolutions on the CPU, XLA's and torch's, which sum in other
orders (about 1e-6 relative on the head), so a detection's confidence may
differ in its last bits and two near-equal ones may swap places in a ranking.
"""

import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from yolojax.cli.common import build as jbuild
from yolojax.cli.eval import run_eval as jrun_eval
from yolojax.config import load_config as jload_config
from yolojax.data.synth import CLASSES, generate_coco, generate_voc
from yolojax.utils import checkpoint as jckpt
from yolojax_torch.cli.cache import main as cache_main
from yolojax_torch.cli.common import build, load_weights_auto
from yolojax_torch.cli.estimate import main as estimate_main
from yolojax_torch.cli.eval import main as eval_main
from yolojax_torch.cli.eval import run_eval
from yolojax_torch.config import get_eval_db, get_model_dir, load_config
from yolojax_torch.data.cache import load_cache

ROOT = Path(__file__).resolve().parents[1]
SIZE = 64


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _workspace(root: Path, kind: str) -> list[str]:
    """A synthetic workspace, its cache and anchors → the config arguments."""
    data = (generate_voc(str(root / "data"), 14, seed=11) if kind == "voc" else
            generate_coco(str(root / "data"), 14, seed=12, num_classes=8, crowd_frac=0.3))
    (root / "cat8").write_text("\n".join(CLASSES))
    datasets = (f"yolojax.data.voc\nvoc_roots = {data}" if kind == "voc" else
                f"yolojax.data.coco\ncoco_root = {data}\n[eval]\nprotocol = coco")
    overlay = root / "ws.ini"
    overlay.write_text(f"""[config]
root = {root}/art
[cache]
category = {root}/cat8
datasets = {datasets}
[model]
name = eval
anchors = {root}/anchors.tsv
dtype = float32
[data]
canvas = 160
sizes = {SIZE},{SIZE}
workers = 2
""")
    (root / "anchors.tsv").write_text("1.0\t1.0\n")
    cfg = ["-c", str(ROOT / "config.ini"), str(overlay)]
    assert cache_main(cfg + ["-p", "train", "test"]) == 0
    assert estimate_main(cfg + ["-k", "5", "--size", str(SIZE), "-o",
                                str(root / "anchors.tsv")]) == 0
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """{kind: config args} and the JAX package's seeded weights (saved as
    the model dir's checkpoint of each workspace)."""
    cfgs = {kind: _workspace(tmp_path_factory.mktemp(kind), kind) for kind in ("voc", "coco")}
    config = jload_config(cfgs["voc"][1:])
    _, _, jmodel = jbuild(config)
    params, state = jmodel.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    rng = np.random.default_rng(0)
    for name in state:
        state[name]["mean"] = rng.normal(0, 0.1, state[name]["mean"].shape).astype(np.float32)
        state[name]["var"] = rng.uniform(0.8, 1.2, state[name]["var"].shape).astype(np.float32)
    for cfg in cfgs.values():
        model_dir = Path(get_model_dir(load_config(cfg[1:])))
        model_dir.mkdir(parents=True)
        jckpt.save(str(model_dir / "3.npz"), {"params": params, "state": state}, {"step": 3})
    return cfgs, params, state


def _jax_eval(cfg, params, state, batch=16):
    config = jload_config(cfg[1:])
    category, _, jmodel = jbuild(config)          # the workspace's own anchors
    return jrun_eval(config, jmodel, params, state, load_cache(config, "test"), SIZE, batch,
                     category)


@pytest.fixture(scope="module")
def reference(setup):
    """The JAX package's run_eval on each workspace, batch 16."""
    cfgs, params, state = setup
    return {kind: _jax_eval(cfg, params, state) for kind, cfg in cfgs.items()}


def _port_eval(cfg, mods=(), batch=16):
    config = load_config(cfg[1:], mods)
    category, _, model = build(config)
    params, state, meta = load_weights_auto(config, model, resume=True)
    assert meta["step"] == 3
    return run_eval(config, model, params, state, load_cache(config, "test"), SIZE, batch,
                    category)


def _close(got, want):
    assert abs(got["map"] - want["map"]) <= 1e-4, (got["map"], want["map"])
    assert got["ap"].keys() == want["ap"].keys() and len(want["ap"]) >= 5
    for c, ap in want["ap"].items():
        assert abs(got["ap"][c] - ap) <= 1e-3, (c, got["ap"][c], ap)
    for k in ("map_50", "map_75"):
        assert (k in got) == (k in want)
        if k in want:
            assert abs(got[k] - want[k]) <= 1e-4, k


@pytest.mark.parametrize("variant", ["fusedpost", "nms", "partial batch", "coco"])
def test_run_eval_matches_the_reference(setup, reference, variant):
    cfgs = setup[0]
    kind = "coco" if variant == "coco" else "voc"
    mods = ["model/pallas=nms"] if variant == "nms" else []
    got = _port_eval(cfgs[kind], mods, batch=3 if variant == "partial batch" else 16)
    want = reference[kind]
    _close(got, want)
    assert want["map"] > 0          # the anchors fit the data: some boxes match
    n = sum(len(d) for d in want["recorder"].dets.values())
    assert sum(len(d) for d in got["recorder"].dets.values()) == n > 0
    assert got["recorder"].gts.keys() == want["recorder"].gts.keys()


def _rows(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def test_main_runs_end_to_end(setup, reference, tmp_path, capsys):
    cfg = setup[0]["voc"]
    results = tmp_path / "dets.jsonl"
    assert eval_main(cfg + ["--device", "cpu", "--results", str(results)]) == 0
    printed = capsys.readouterr().out
    want = reference["voc"]
    m = re.search(r"^mAP = (\d\.\d{4})$", printed, re.M)
    assert m and abs(float(m.group(1)) - want["map"]) <= 1e-4 + 5e-5
    # the detections, in the reference's recording order, to 1e-4
    category = CLASSES
    rows = _rows(results)
    ref = [(c, img, conf, dmin, dmax) for c, dets in want["recorder"].dets.items()
           for img, conf, dmin, dmax in dets]
    assert len(rows) == len(ref)
    for row, (c, img, conf, dmin, dmax) in zip(rows, ref):
        assert (row["image"], row["category"]) == (img, category[c])
        assert abs(row["conf"] - conf) <= 1e-4
        np.testing.assert_allclose(row["yx_min"] + row["yx_max"], [*dmin, *dmax], atol=1e-4)
    config = load_config(cfg[1:])
    (db_row,) = _rows(get_eval_db(config))
    assert set(db_row) == {"time", "size", "map", "ap"} and db_row["size"] == SIZE
    assert abs(db_row["map"] - want["map"]) <= 1e-4
    scalars = _rows(Path(get_model_dir(config)) / "scalars.jsonl")
    assert scalars[-1]["step"] == 3 and scalars[-1]["eval/mAP"] == db_row["map"]


def test_eval_refuses_what_is_not_ported(setup, monkeypatch):
    """What eval refuses now that eval across ranks is ported: ``--device
    cuda`` (the default) where torch sees no card, ``WORLD_SIZE > 1``
    without the rendezvous torchrun sets, and ``run_eval`` under
    ``WORLD_SIZE > 1`` without a group (no rank evaluates alone)."""
    cfg = setup[0]["voc"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            eval_main(cfg)              # --device defaults to cuda
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2 but RANK, LOCAL_RANK, MASTER_ADDR"):
        eval_main(cfg + ["--device", "cpu"])
    with pytest.raises(RuntimeError, match="run_eval got no group"):
        _port_eval(cfg)
