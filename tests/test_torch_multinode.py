"""The port's train and eval CLIs launched as users launch them across
machines: ``torchrun`` (``python -m torch.distributed.run``) on two nodes of
two ranks each, all four gloo ranks on this host,

    python -m torch.distributed.run --nnodes 2 --nproc-per-node 2 --node-rank {0,1}
        --master-addr 127.0.0.1 --master-port P -m yolojax_torch.cli.train … --device cpu

each rank with the environment torchrun sets (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE=4``, ``LOCAL_WORLD_SIZE=2``, ``GROUP_RANK``, ``MASTER_*``), from
which ``parallel/collectives.py::init_from_env`` starts the group itself.
This is the counterpart of the JAX package's two-process pod
(``scripts/multihost_worker.py``, held by ``tests/test_multihost.py`` to one
process on the same global batches).

The workspace is ``tests/test_torch_batch_unit.py``'s (the train CLI test's
synthetic VOC layout, Tiny, float32, a fixed 64², no augmentation, clip 5)
with 24 train images, so that an epoch holds three global batches of 8;
``data/batch_size=4`` is the node's batch, 2 a rank.  Held, for the loader
and for the device-resident dataset:

* the counters of the JAX package's train CLI: ``steps_per_epoch ==
  len(dataset) // 4`` on every rank and ``seen`` growing by 8 (the node's
  batch times the nodes) a step;
* the shards: each rank's rows are disjoint from the others', the four make
  the epoch, and each step's global batch is the set of rows the JAX
  package's one-process ``Train`` at ``data/batch_size=8`` reads, the
  epoch's ``order[8s:8s+8]``;
* the params of rank 0's checkpoint after 3 steps against that JAX run to
  rtol 1e-4 (atol 1e-6), ``test_torch_batch_unit.py``'s bound;
* a ``-r`` resume over the same two nodes continues ``step`` and ``seen``;
* ``python -m yolojax_torch.cli.eval`` under the same launch gives one
  process's mAP, each class's AP and detections (``test_torch_dist_eval.py``'s
  1e-6; the ``--results`` file rounds ``conf`` to 5 decimals).
"""

import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_batch_unit import MODS
from test_torch_train_cli import ANCHORS, CLASSES
from torch_port_families import one_thread
from yolojax.models.darknet import Tiny as JaxTiny
from yolojax.utils import checkpoint as jckpt
from yolojax_torch.parallel.collectives import _free_port
from yolojax_torch.utils import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
NODES, PER_NODE = 2, 2
RANKS = NODES * PER_NODE
NODE_BATCH = 4                      # [data] batch_size: the node's
GLOBAL_BATCH = NODE_BATCH * NODES
IMAGES = 24                         # three global batches an epoch
STEPS, RESUME_STEPS = 3, 4
LAUNCH_TIMEOUT = 300
PATHS = {"loader": [], "device_dataset": ["data/device_dataset=1"]}
TRAINING = re.compile(r"training (\d+) steps \((\d+)/epoch\) on cpu, rank (\d+) of (\d+)")


def _workspace(root: Path) -> list:
    """``test_torch_train_cli.py``'s synthetic VOC layout and overlay at
    IMAGES images, its cache built by the port's cache CLI; returns the
    config args."""
    import cv2

    from yolojax_torch.cli.cache import main as cache_main

    voc = root / "VOC2007"
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        (voc / sub).mkdir(parents=True)
    rng = np.random.default_rng(3)
    ids = []
    for i in range(IMAGES):
        h, w = 96, 128
        img = np.full((h, w, 3), 40, np.uint8)
        cls = i % 2
        y0, x0 = int(rng.integers(8, h - 40)), int(rng.integers(8, w - 40))
        img[y0:y0 + 32, x0:x0 + 32] = (255, 64, 64) if cls == 0 else (64, 255, 64)
        ids.append(f"{i:06d}")
        cv2.imwrite(str(voc / "JPEGImages" / f"{ids[-1]}.jpg"), img[:, :, ::-1])
        (voc / "Annotations" / f"{ids[-1]}.xml").write_text(f"""<annotation>
<size><width>{w}</width><height>{h}</height></size>
<object><name>{CLASSES[cls]}</name><difficult>0</difficult>
<bndbox><xmin>{x0 + 1}</xmin><ymin>{y0 + 1}</ymin><xmax>{x0 + 32}</xmax><ymax>{y0 + 32}</ymax></bndbox>
</object></annotation>""")
    for phase in ("trainval", "val", "test"):
        (voc / "ImageSets" / "Main" / f"{phase}.txt").write_text("\n".join(ids))
    (root / "category2").write_text("\n".join(CLASSES))
    (root / "anchors.tsv").write_text("\n".join("\t".join(map(str, a)) for a in ANCHORS) + "\n")
    overlay = root / "multinode.ini"
    overlay.write_text(f"""[config]
root = {root}/artifacts
[cache]
datasets = yolojax.data.voc
category = {root}/category2
voc_roots = {voc}
[model]
name = multinode
dnn = yolojax.models.darknet.Tiny
anchors = {root}/anchors.tsv
dtype = float32
[data]
max_boxes = 5
canvas = 160
sizes = 64,64
workers = 2
[train]
clip = 5.0
seed = 0
[eval]
batch_size = {GLOBAL_BATCH}
[save]
interval = 1e9
keep = 10
""")
    cfg = ["-c", str(ROOT / "config.ini"), str(overlay)]
    assert cache_main(cfg) == 0
    return cfg


def _model_dir(root: Path, name: str) -> Path:
    return root / "artifacts" / "model" / "category2" / "Tiny" / name


def _train_argv(cfg, name: str, *extra) -> list:
    mods = [m for m in MODS if not m.startswith("data/batch_size=")]
    return [*cfg, "-m", *mods, f"data/batch_size={NODE_BATCH}", f"model/name={name}", *extra]


@contextlib.contextmanager
def torchrun(module: str, argv: list, log: Path):
    """``module`` under two ``torch.distributed.run`` launchers, nodes 0 and 1
    of two ranks each, on this host, both writing to ``log``; yields a
    function that waits for them and returns ``log``'s text.  Each launcher
    runs in a session of its own, so leaving the block stops it and its
    ranks if they still run."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    port = _free_port()
    with open(log, "w") as out:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(NODES),
             "--nproc-per-node", str(PER_NODE), "--node-rank", str(node), "--master-addr",
             "127.0.0.1", "--master-port", str(port), "-m", module, *argv],
            cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
            for node in range(NODES)]

    def finish() -> str:
        deadline = time.monotonic() + LAUNCH_TIMEOUT
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
        text = log.read_text()
        assert rcs == [0] * NODES, f"{module}: the nodes exited {rcs}:\n{text[-6000:]}"
        return text

    try:
        yield finish
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()


def _ranks_logged(log: str) -> dict:
    """{rank: (steps, steps an epoch, world)} from each rank's "training …" line."""
    found = {int(r): (int(s), int(e), int(w)) for s, e, r, w in TRAINING.findall(log)}
    assert sorted(found) == list(range(RANKS)), log[-4000:]
    return found


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(root, config args, the start checkpoint): the workspace and the JAX
    package's seeded Tiny as an npz both packages train from."""
    root = tmp_path_factory.mktemp("multinode")
    cfg = _workspace(root)
    params, state = JaxTiny(anchors=ANCHORS, num_classes=2, dtype=jnp.float32).init(
        jax.random.PRNGKey(5))
    start = str(root / "start.npz")
    jckpt.save(start, {"params": params, "state": state}, {})
    return root, cfg, start


@pytest.fixture(scope="module")
def runs(workspace):
    """Everything the tests of the launch read: the port's two-node train of
    each data path, 3 steps from one start; the JAX package's one-process
    run at the global batch and the port's; then a two-node eval of the
    loader run's checkpoint and the same eval in this process, and a
    two-node ``-r`` of the device-dataset run.  One launch at a time, so
    that the file holds at most six processes (two launchers, four ranks)
    beside the suite's other workers.  Returns {"root", "cfg", "start",
    "ref": (steps an epoch, seen, each step's rows), "logs"}."""
    from yolojax.cli import setup as jax_setup
    from yolojax.cli.train import Train as JaxTrain
    from yolojax.data.loader import Loader as JaxLoader
    from yolojax_torch.cli.eval import main as eval_main
    from yolojax_torch.cli.train import main as train_main
    from yolojax_torch.cli.train import train_parser

    root, cfg, start = workspace
    logs = {}
    with pytest.MonkeyPatch.context() as mp, one_thread(mp):
        first = ["-f", start, "--steps", str(STEPS)]
        for path, mods in PATHS.items():
            with torchrun("yolojax_torch.cli.train",
                          _train_argv(cfg, path, *mods, *first, "--device", "cpu"),
                          root / f"{path}.log") as launched:
                logs[path] = launched()
        one = [*first, "-m", f"data/batch_size={GLOBAL_BATCH}"]
        args = train_parser().parse_args(_train_argv(cfg, "ref", *one))
        ref = JaxTrain(args, jax_setup(args))
        assert ref.batch_size == GLOBAL_BATCH
        ref(max_steps=STEPS)
        assert train_main(_train_argv(cfg, "one", *one, "--device", "cpu")) == 0
        # the rows the JAX run read: a second loader from its seed draws the same epoch
        epoch = JaxLoader(ref.loader.dataset, GLOBAL_BATCH, workers=1, seed=0).epoch()
        rows = [next(epoch)["index"].tolist() for _ in range(STEPS)]

        evaluate = [*cfg, "-m", "model/name=loader", "-f",
                    str(_model_dir(root, "loader") / f"{STEPS}.npz"), "--size", "64",
                    "--device", "cpu", "--results"]
        with torchrun("yolojax_torch.cli.eval", [*evaluate, str(root / "nodes.jsonl")],
                      root / "eval.log") as launched:
            logs["eval"] = launched()         # first: its row comes first in eval.jsonl
        assert eval_main([*evaluate, str(root / "one.jsonl")]) == 0
        with torchrun("yolojax_torch.cli.train",
                      _train_argv(cfg, "device_dataset", *PATHS["device_dataset"], "-r",
                                  "--steps", str(RESUME_STEPS), "--device", "cpu"),
                      root / "resume.log") as launched:
            logs["resume"] = launched()
    return {"root": root, "cfg": cfg, "start": start,
            "ref": (ref.steps_per_epoch, ref.seen, rows), "logs": logs}


@pytest.mark.parametrize("path", PATHS)
def test_counters_follow_the_reference_formulas(runs, path):
    ref_steps_per_epoch, ref_seen, _ = runs["ref"]
    assert ref_steps_per_epoch == IMAGES // GLOBAL_BATCH and ref_seen == GLOBAL_BATCH * STEPS
    logged = _ranks_logged(runs["logs"][path])
    # yolojax/cli/train.py: steps_per_epoch = len(dataset) // batch_size (the node's batch)
    assert set(logged.values()) == {(STEPS, IMAGES // NODE_BATCH, RANKS)}
    _, meta = ckpt.load(str(_model_dir(runs["root"], path) / f"{STEPS}.npz"), ())
    # ... and seen += batch_size * process_count a step
    assert meta == {"step": STEPS, "seen": NODE_BATCH * NODES * STEPS}


def _jax_pod_rows(dataset) -> list:
    """Each step's global batch, row by row, as the JAX package's pod of NODES
    processes assembles it (``tests/test_multihost.py``'s reference): each
    process's ``Loader(shard=(p, NODES))`` batch of NODE_BATCH, in process
    order."""
    from yolojax.data.loader import Loader as JaxLoader

    epochs = [JaxLoader(dataset, NODE_BATCH, workers=1, seed=0, shard=(p, NODES)).epoch()
              for p in range(NODES)]
    return [[i for it in epochs for i in next(it)["index"].tolist()] for _ in range(STEPS)]


@pytest.mark.parametrize("path", PATHS)
def test_each_step_reads_the_reference_rows_in_the_reference_layout(runs, path):
    """The rows each rank reads, from the port's loader or device dataset
    built as ``Train`` builds them on rank ``r`` (``RANK``) of WORLD_SIZE with
    LOCAL_WORLD_SIZE ranks a node: disjoint, together the epoch, each step
    the set of rows the JAX one-process run read; in rank order, the loader's
    global batch is the JAX pod's row for row (each node a JAX process) and
    the device dataset's one process's (the JAX package's device dataset
    gathers the global index batch on every process count)."""
    from yolojax_torch import config as tconfig
    from yolojax_torch.cli import setup
    from yolojax_torch.cli.train import train_parser
    from yolojax_torch.data.cache import load_cache
    from yolojax_torch.data.dataset import Dataset
    from yolojax_torch.data.device_cache import DeviceDataset
    from yolojax_torch.data.loader import Loader

    _, _, want = runs["ref"]
    config = setup(train_parser().parse_args(_train_argv(runs["cfg"], path, *PATHS[path])))
    dataset = Dataset(load_cache(config, "train"), canvas=tconfig.get_canvas(config), max_boxes=5)
    per_rank = NODE_BATCH // PER_NODE
    shards = []
    for r in range(RANKS):
        if path == "loader":
            node, place = divmod(r, PER_NODE)
            it = Loader(dataset, per_rank, workers=1, seed=0, shard=(node, NODES),
                        part=(place, PER_NODE)).epoch()
            shards.append([next(it)["index"].tolist() for _ in range(STEPS)])
            continue
        source, gathered = DeviceDataset(dataset, "cpu", per_rank, seed=0, shard=(r, RANKS)), []
        gather = source.gather
        source.gather = lambda idx: gathered.append(list(idx)) or gather(idx)
        it = iter(source)
        for _ in range(STEPS):
            next(it)
        shards.append(gathered)
    rows = [i for shard in shards for step in shard for i in step]
    assert all(len(step) == per_rank for shard in shards for step in shard)
    assert len(rows) == len(set(rows)) == IMAGES               # disjoint; together the epoch
    layout = [[i for shard in shards for i in shard[s]] for s in range(STEPS)]
    assert [set(step) for step in layout] == [set(step) for step in want]
    if path == "loader":
        from yolojax.data.dataset import Dataset as JaxDataset

        assert layout == _jax_pod_rows(JaxDataset(load_cache(config, "train"), max_boxes=5))
    else:
        assert layout == want


def test_a_node_of_two_ranks_sees_one_process_pixels_through_the_loader(workspace,
                                                                          monkeypatch):
    """Augmentation on (``config.ini``'s), through the loader, one node of two
    ranks (``LOCAL_WORLD_SIZE=2``) at ``data/batch_size=4`` against the port's
    one process at the same batch: each image takes the same draw, so the
    params after two steps agree to rtol 1e-4 (atol 1e-6), the bound of two
    ranks against one process where only the sums' order differs."""
    import torch_dist_ranks

    from yolojax_torch.parallel.collectives import run_ranks

    root, cfg, start = workspace
    mods = [m for m in MODS if m not in ("transform/train=", "transform/dtype=float32")]
    argv = [*cfg, "-f", start, "--steps", "2", "--device", "cpu", "-m", *mods,
            f"data/batch_size={NODE_BATCH}"]
    with one_thread(monkeypatch):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(PER_NODE))
        ranks = run_ranks(torch_dist_ranks.train_cli, PER_NODE, argv + ["model/name=aug-ranks"])
        monkeypatch.delenv("LOCAL_WORLD_SIZE")
        one = torch_dist_ranks.train_cli(None, argv + ["model/name=aug-one"])
    assert [r["batch"] for r in ranks] == [NODE_BATCH // PER_NODE] * PER_NODE
    assert one["batch"] == NODE_BATCH and ranks[0]["digest"] == ranks[1]["digest"]
    got = ckpt.load(str(_model_dir(root, "aug-ranks") / "2.npz"), ("params",))[0]["params"]
    want = ckpt.load(str(_model_dir(root, "aug-one") / "2.npz"), ("params",))[0]["params"]
    for k, lp in want.items():
        for n, v in lp.items():
            np.testing.assert_allclose(got[k][n], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"params {k}.{n}")


def _params(root: Path, name: str) -> dict:
    return ckpt.load(str(_model_dir(root, name) / f"{STEPS}.npz"), ("params",))[0]["params"]


@pytest.mark.parametrize("path", PATHS)
def test_params_after_three_steps_match_one_process_at_the_global_batch(runs, path):
    """Rank 0's checkpoint against the port's one process at
    ``data/batch_size=8`` (rtol 1e-4, atol 1e-6, ``test_torch_batch_unit.py``'s
    bound), and against the JAX package's (the bounds it holds its own
    two-process pod to, ``tests/test_multihost.py``: rtol 1e-3, atol 1e-5;
    and ``test_torch_batch_unit.py``'s 1e-2 on the change of the params over
    the model).  After 3 steps XLA's and torch's float32 convolutions and BN
    sums lie up to ~7e-6 apart on Tiny's c8 (~0.9 % of the change), on one
    process as on the four ranks, which is above 1e-4 / 1e-6 there."""
    root = runs["root"]
    got, one, ref = _params(root, path), _params(root, "one"), _params(root, "ref")
    start = ckpt.load(runs["start"], ("params",))[0]["params"]
    diff = norm = 0.0
    for k, lp in ref.items():
        for n, v in lp.items():
            np.testing.assert_allclose(got[k][n], one[k][n], rtol=1e-4, atol=1e-6,
                                       err_msg=f"params {k}.{n} against one process")
            np.testing.assert_allclose(got[k][n], v, rtol=1e-3, atol=1e-5,
                                       err_msg=f"params {k}.{n} against the JAX package")
            diff += float(np.sum((got[k][n] - v) ** 2))
            norm += float(np.sum((v - start[k][n]) ** 2))
    assert norm > 0 and np.sqrt(diff / norm) < 1e-2, (diff, norm)


def test_resume_over_two_nodes_continues_step_and_seen(runs):
    log = runs["logs"]["resume"]
    assert log.count("loaded checkpoint") == RANKS and "reinitializing" not in log
    assert set(_ranks_logged(log).values()) == {(RESUME_STEPS, IMAGES // NODE_BATCH, RANKS)}
    trees, meta = ckpt.load(
        str(_model_dir(runs["root"], "device_dataset") / f"{RESUME_STEPS}.npz"), ("opt",))
    assert meta == {"step": RESUME_STEPS, "seen": GLOBAL_BATCH * RESUME_STEPS}
    assert int(trees["opt"]["count"]) == RESUME_STEPS


def _results(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_eval_over_two_nodes_matches_one_process(runs):
    root = runs["root"]
    assert runs["logs"]["eval"].count("mAP = ") == 1                # rank 0 prints
    nodes, one = (json.loads(line) for line in
                  (_model_dir(root, "loader") / "eval.jsonl").read_text().splitlines())
    assert abs(nodes["map"] - one["map"]) <= 1e-6 and nodes["ap"].keys() == one["ap"].keys()
    assert all(abs(nodes["ap"][c] - ap) <= 1e-6 for c, ap in one["ap"].items())
    got, want = _results(root / "nodes.jsonl"), _results(root / "one.jsonl")
    assert len(want) > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        assert (g["image"], g["category"]) == (w["image"], w["category"])
        # conf is written rounded to 5 decimals: a 1e-6 gap may cross one rounding step
        assert abs(g["conf"] - w["conf"]) <= 1e-5 + 1e-6 * abs(w["conf"])
        np.testing.assert_allclose(g["yx_min"] + g["yx_max"], w["yx_min"] + w["yx_max"],
                                   atol=1e-5)
