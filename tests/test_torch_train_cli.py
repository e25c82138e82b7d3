"""The port's checkpoint writer and train CLI.

* ``checkpoint.save`` → ``yolojax.utils.checkpoint.load`` and back: params
  and state keep the JAX package's key paths and layouts both ways;
* ``Saver``'s seconds cadence and keep-N window, as the JAX package's;
* end to end on a synthetic VOC workspace (as
  ``tests/test_cli_end_to_end.py::workspace`` builds it, cache by the JAX
  package's ``cache`` CLI): ``python -m yolojax_torch.cli.train --device cpu
  --steps 3``, then ``-r --steps 5``; the JAX package's train CLI resumes
  from the port's checkpoint and the port from the JAX package's (whose
  optimizer state it cannot take, so it starts a fresh one); the port's
  detect CLI runs on the result.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from yolojax.models.darknet import Tiny as JaxTiny
from yolojax.utils import checkpoint as jckpt
from yolojax_torch.models.darknet import Tiny
from yolojax_torch.utils import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]
ANCHORS = np.asarray([[1.0, 1.0], [2.5, 2.5]], np.float32)
CLASSES = ["square", "blob"]
COMPONENTS = ("coord", "object", "noobject", "cls", "prior")


def test_port_checkpoint_loads_in_jax_and_back(tmp_path):
    model = Tiny(anchors=ANCHORS, num_classes=3, dtype=torch.float32)
    params, state = model.init(torch.Generator().manual_seed(3))
    params["c1"]["gamma"] += 0.5
    state["c2"]["var"] += 0.25
    path = str(tmp_path / "9.npz")
    opt = {"count": 4, "trace": {"c1": {"w": torch.ones(2)}}}
    ckpt.save(path, {**dict(zip(("params", "state"), ckpt.to_jax(params, state))), "opt": opt},
              {"step": 9, "seen": 144})

    jparams, jstate = JaxTiny(anchors=ANCHORS, num_classes=3).init(jax.random.PRNGKey(0))
    trees, meta = jckpt.load(path, {"params": jparams, "state": jstate})
    assert meta == {"step": 9, "seen": 144}
    back = ckpt.from_jax(jax.tree_util.tree_map(np.asarray, trees["params"]),
                         jax.tree_util.tree_map(np.asarray, trees["state"]))
    for mine, theirs in zip((params, state), back):
        for k, lp in mine.items():
            for n, v in lp.items():
                assert torch.equal(theirs[k][n], v), (k, n)
    assert np.asarray(trees["params"]["c1"]["w"]).shape == (3, 3, 3, 16)   # HWIO
    assert ckpt.contains(path, "opt") and jckpt.contains(path, "opt")
    got, _ = ckpt.load(path, ("opt",))
    assert int(got["opt"]["count"]) == 4 and got["opt"]["trace"]["c1"]["w"].tolist() == [1, 1]


def test_jax_checkpoint_with_optimizer_state_loads_in_the_port(tmp_path):
    import optax

    jparams, jstate = JaxTiny(anchors=ANCHORS, num_classes=3).init(jax.random.PRNGKey(1))
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.sgd(0.1, momentum=0.9))
    path = str(tmp_path / "2.npz")
    jckpt.save(path, {"params": jparams, "state": jstate, "opt": jopt.init(jparams)},
               {"step": 2, "seen": 32})
    trees, meta = ckpt.load(path)
    assert meta == {"step": 2, "seen": 32}
    assert trees["opt"][1][0]["trace"]["c1"]["w"].shape == (3, 3, 3, 16)
    params, state = ckpt.from_jax(trees["params"], trees["state"])
    np.testing.assert_array_equal(params["c1"]["w"].numpy(),
                                  np.asarray(jparams["c1"]["w"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["c1"]["var"].numpy(), np.asarray(jstate["c1"]["var"]))


def test_saver_cadence_and_keep(tmp_path):
    for module, d in ((ckpt, "port"), (jckpt, "jax")):
        saver = module.Saver(str(tmp_path / d), interval=10.0, keep=2)
        assert not saver.due(0.0)       # the first call arms the timer
        assert not saver.due(5.0)
        assert saver.due(11.0)
        for i, t in enumerate([11.0, 22.0, 33.0]):
            saver(t, i, {"params": {"c1": {"w": np.full(3, i, np.float32)}}}, {"step": i})
        assert not saver.due(40.0) and saver.due(43.0)
        assert sorted(os.listdir(tmp_path / d)) == ["1.npz", "2.npz"]
        assert module.latest(str(tmp_path / d)).endswith("2.npz")
        assert not any(p.endswith(".tmp") for p in os.listdir(tmp_path / d))


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Synthetic VOC layout + config overlay, cache built by the JAX package's
    cache CLI; returns (root, config_args)."""
    import cv2

    from yolojax.cli.cache import main as cache_main

    root = tmp_path_factory.mktemp("ws")
    voc = root / "VOC2007"
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        (voc / sub).mkdir(parents=True)
    rng = np.random.default_rng(3)
    ids = []
    for i in range(6):
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
    (root / "anchors.tsv").write_text("1.0\t1.0\n2.5\t2.5\n")
    overlay = root / "test.ini"
    overlay.write_text(f"""[config]
root = {root}/artifacts
[cache]
datasets = yolojax.data.voc
category = {root}/category2
voc_roots = {voc}
[model]
name = e2e
dnn = yolojax.models.darknet.Tiny
anchors = {root}/anchors.tsv
dtype = float32
[data]
batch_size = 2
max_boxes = 5
canvas = 160
sizes = 64,64
workers = 2
[train]
learning_rate = 1e-4
clip = 5.0
multi_scale_min = 64
multi_scale_max = 96
multi_scale_interval = 2
prewarm = 1
warmup_seen = 0
seed = 0
[detect]
threshold = 0.05
topk = 5
[summary]
scalar = 1
histogram = 2
image = 2
[save]
interval = 1e9
keep = 10
""")
    cfg = ["-c", str(ROOT / "config.ini"), str(overlay)]
    assert cache_main(cfg) == 0
    return root, cfg


def model_dir(root):
    return root / "artifacts" / "model" / "category2" / "Tiny" / "e2e"


def run(args, timeout=300):
    # one torch thread a child: six test workers share the host's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stderr


def test_train_cli_runs_resumes_and_crosses_packages(workspace):
    root, cfg = workspace
    train = ["-m", "yolojax_torch.cli.train", *cfg, "--device", "cpu"]
    log = run([*train, "--steps", "3"])
    assert "prewarmed size 96" in log
    assert {"3.npz", "scalars.jsonl"} <= set(os.listdir(model_dir(root)))
    rows = [json.loads(line) for line in (model_dir(root) / "scalars.jsonl").read_text().split("\n")
            if line]
    assert [r["step"] for r in rows] == [1, 2, 3]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in (*COMPONENTS, "total", "grad_norm", "lr"))
        assert r["size"] in (64, 96)
    _, meta = ckpt.load(str(model_dir(root) / "3.npz"), ())
    assert meta == {"step": 3, "seen": 6}

    log = run([*train, "-r", "--steps", "5"])
    assert "reinitializing" not in log and "loaded checkpoint" in log
    trees, meta = ckpt.load(str(model_dir(root) / "5.npz"), ("opt",))
    assert meta == {"step": 5, "seen": 10} and int(trees["opt"]["count"]) == 5

    # the JAX package resumes from the port's checkpoint, the port from its
    run(["-c", f"import sys; from yolojax.cli.train import main; sys.exit(main({cfg!r} + "
         "['-r', '--steps', '6', '-m', 'train/prewarm=0']))"], timeout=600)
    _, meta = jckpt.load(str(model_dir(root) / "6.npz"), {})
    assert meta == {"step": 6, "seen": 12}
    log = run([*train, "-r", "--steps", "7", "-m", "train/prewarm=0"])
    assert "does not fit this optimizer; reinitializing" in log
    trees, meta = ckpt.load(str(model_dir(root) / "7.npz"), ("opt",))
    assert meta == {"step": 7, "seen": 14} and int(trees["opt"]["count"]) == 1

    out = root / "det.png"
    log = run(["-m", "yolojax_torch.cli.detect", str(root / "VOC2007" / "JPEGImages" /
                                                      "000000.jpg"), *cfg, "--size", "64",
               "--device", "cpu", "-o", str(out)])
    assert out.exists() and "7.npz" in log


def test_train_cli_refuses_what_is_not_ported(workspace, monkeypatch):
    """What the train CLI refuses now that training across devices and the
    device-resident dataset are ported: ``--device cuda`` (the default)
    where torch sees no card, and ``WORLD_SIZE > 1`` without the rendezvous
    torchrun sets (no group to join: no rank goes on alone)."""
    from yolojax_torch.cli.train import main

    _, cfg = workspace
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(cfg)
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2 but RANK, LOCAL_RANK, MASTER_ADDR"):
        main(cfg + ["--device", "cpu"])


def _trained(root, name: str):
    trees, meta = ckpt.load(str(model_dir(root).parent / name / "3.npz"), ("params", "state"))
    return trees, meta


def _assert_same_trees(a, b, exact: bool):
    for key in ("params", "state"):
        for k, lp in b[key].items():
            for n, v in lp.items():
                if exact:
                    np.testing.assert_array_equal(a[key][k][n], v, err_msg=f"{key} {k}.{n}")
                else:
                    np.testing.assert_allclose(a[key][k][n], v, rtol=1e-4, atol=1e-6,
                                               err_msg=f"{key} {k}.{n}")


def test_train_cli_device_dataset_trains_what_the_loader_feeds(workspace):
    """``[data] device_dataset = 1`` on the CPU: three steps from the same
    seed give the loader path's checkpoint bit for bit (the same batches,
    gathered on the device)."""
    from yolojax_torch.cli.train import main

    root, cfg = workspace
    for name, extra in (("loader", []), ("devdata", ["data/device_dataset=1"])):
        assert main(cfg + ["--device", "cpu", "--steps", "3", "-m", f"model/name={name}",
                           "train/prewarm=0", *extra]) == 0
    (got, meta), (want, want_meta) = _trained(root, "devdata"), _trained(root, "loader")
    assert meta == want_meta == {"step": 3, "seen": 6}
    _assert_same_trees(got, want, exact=True)


def test_train_cli_on_two_ranks_matches_one_process(workspace):
    """``Train`` on two gloo ranks with the device-resident dataset, against
    one process, from the same ini: ``[data] batch_size = 2`` is the node's,
    so each rank trains on 1 image and the process on 2, the same global
    batches and draws,
    so the same training up to float32 rounding (the BN statistics and the
    gradients meet in other orders); both ranks end bit-identical, rank 0
    alone writes, ``seen`` counts the global batch."""
    import torch_dist_ranks

    from yolojax_torch.parallel.collectives import run_ranks

    root, cfg = workspace
    argv = cfg + ["--device", "cpu", "--steps", "3", "-m", "train/prewarm=0",
                  "data/device_dataset=1"]
    ranks = run_ranks(torch_dist_ranks.train_cli, 2, argv + ["model/name=ranks"])
    one = torch_dist_ranks.train_cli(None, argv + ["model/name=one"])
    assert [(r["step"], r["seen"], r["lead"]) for r in ranks] == [(3, 6, True), (3, 6, False)]
    assert [r["batch"] for r in ranks] == [1, 1] and one["batch"] == 2
    assert [r["steps_per_epoch"] for r in ranks] == [one["steps_per_epoch"]] * 2
    assert ranks[0]["digest"] == ranks[1]["digest"] and one["lead"]
    (got, meta), (want, want_meta) = _trained(root, "ranks"), _trained(root, "one")
    assert meta == want_meta == {"step": 3, "seen": 6}
    _assert_same_trees(got, want, exact=False)


def test_train_cli_profile_window_logs_each_phase(workspace, tmp_path, caplog):
    """``--profile DIR``: the Chrome trace of steps 11-20 carries the train
    step's spans, and the window's end logs the median host ms a step of
    each of its phases (``cli/train.py::step_phases``)."""
    import logging

    from yolojax_torch.cli.train import main

    _, cfg = workspace
    out = tmp_path / "profile"
    with caplog.at_level(logging.INFO, logger="yolojax_torch.cli.train"):
        assert main(cfg + ["--device", "cpu", "--steps", "21", "--profile", str(out), "-m",
                           "model/name=profiled", "train/prewarm=0"]) == 0
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("host ms a step in the window")]
    assert len(lines) == 1
    phases = dict(item.rsplit(" ", 1) for item in lines[0].split(": ", 1)[1].split(", "))
    assert list(phases) == ["augment", "forward", "loss", "backward", "optimizer"]
    assert all(float(v) > 0 for v in phases.values())
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "yolojax_torch.train_step"]
    assert len(steps) == 10 and all(e.get("cat") == "user_annotation" for e in steps)
