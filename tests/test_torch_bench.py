"""The port's bench (``yolojax_torch/tools/bench.py``) and sustained bench
(``yolojax_torch/tools/sustained_bench.py``) against the reference's
``bench.py`` and ``scripts/sustained_bench.py``, on the CPU.

* the JSON line: both ``main``s with their five bench functions replaced by
  fixed values, under every ``BENCH_MODE`` × ``BENCH_MODEL`` × ``BENCH_SIZE``
  (``BENCH_E2E_DEVDATA`` too): the same line but for the port's ``device``
  key, exactly, or a ``SystemExit`` with the same message in both;
* ``entry.flagship(backbone)`` against ``__graft_entry__._flagship``:
  anchors, classes, kernel tokens and the layer plan, exactly;
* the detect closure: the reference's model at ``PRNGKey(0)`` carried over
  by ``from_jax``; the folded biases (the objectness logit −6 included)
  exactly, and with ``BENCH_SATURATED=1`` (a random head's picks; at −6 a
  64² head has none) the closure's summary at B=2, 64² in f32 within rtol
  1e-5 of the JAX closure's, on the same seeded images, for the fused,
  nms_select and plain routes (JAX's kernels in interpret mode, forced on
  by ``yolojax.models.pallas_active``).  f32 because the two packages' bf16
  convolutions round apart, and a pick near the threshold may then flip;
* the train batch equal to the reference's arrays, and one step's loss
  components within rtol 1e-4 of the reference's at B=2, 64², f32 (the
  first step's bound in ``test_torch_train_step.py``), its ``grad_norm``
  within 5e-3: with 30 boxes an image on a 2×2 grid the reference's f32
  norm lies 1.65e-3 from the value both packages give in f64 (10 938.108,
  2.6e-9 apart), the port's f32 norm 1.4e-5 from it;
* ``bench_e2e`` (Tiny, 8 images, 64², B=2, 2 steps) on the loader and the
  device dataset, serialised or not: a finite positive rate, the workspace
  removed, and with the split the reference's stderr keys;
* ``bench_pipeline`` (8 images, B=4), and its refusal and e2e's without
  OpenCV;
* ``sustained_bench`` for 0.5 s at 64², B=1: the reference's keys, p5 ≤
  p50 ≤ p95, the record written where ``--out`` says;
* ``BENCH_DEVICE=cuda`` with no CUDA device raises.
"""

import ast
import dataclasses
import functools
import importlib.util
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolojax.models as jmodels
import yolojax.parallel.mesh as jmesh
import yolojax_torch.entry as tentry
import yolojax_torch.models.inference as tinference
from yolojax_torch.tools import bench as tbench
from yolojax_torch.tools import sustained_bench as tsustained
from yolojax_torch.utils.checkpoint import from_jax

from torch_port_families import one_thread

ROOT = Path(__file__).resolve().parents[1]
BACKBONES = ("darknet", "tiny", "mobilenet")
SIZE, BATCH = 64, 2
ENV = ("BENCH_BATCH", "BENCH_ITERS", "BENCH_MODE", "BENCH_MODEL", "BENCH_SIZE", "BENCH_PALLAS",
       "BENCH_SATURATED", "BENCH_E2E_DEVDATA", "BENCH_E2E_DECOMP", "BENCH_DEVICE")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def jbench():
    return _load("jax_bench", ROOT / "bench.py")


@pytest.fixture
def env(monkeypatch):
    """A clean bench environment on the CPU; returns ``monkeypatch``."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    return monkeypatch


def _dict_keys(path: Path, marker: str) -> set:
    """The string keys of the dict literal in ``path`` that holds the key
    ``marker``, and of the dicts nested in it."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == marker for k in node.keys):
            return {k.value for d in ast.walk(node) if isinstance(d, ast.Dict)
                    for k in d.keys if isinstance(k, ast.Constant)}
    raise AssertionError(f"no dict with {marker!r} in {path}")


# -- (a) the JSON line ---------------------------------------------------------

FIXED = {"bench_infer": 1234.56789, "bench_train": 87.654321, "bench_e2e": 45.678912,
         "bench_pipeline": 321.98765, "bench_latency": 3.1415926}
MODES = {"infer": {}, "train": {}, "latency": {}, "e2e": {}, "e2e-devdata": {"BENCH_E2E_DEVDATA": "1"},
         "pipeline": {}}


def _line(main, module, monkeypatch, capsys):
    for name, value in FIXED.items():
        monkeypatch.setattr(module, name, lambda *a, _v=value, **k: _v)
    try:
        main()
    except SystemExit as exc:
        return ("exit", str(exc))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return ("line", json.loads(lines[0]))


@pytest.mark.parametrize("size", [320, 416, 544, 608])
@pytest.mark.parametrize("model", BACKBONES)
@pytest.mark.parametrize("mode", MODES)
def test_the_json_line_equals_the_reference(env, jbench, capsys, mode, model, size):
    env.setenv("BENCH_MODE", mode.split("-")[0])
    env.setenv("BENCH_MODEL", model)
    env.setenv("BENCH_SIZE", str(size))
    for k, v in MODES[mode].items():
        env.setenv(k, v)
    want = _line(jbench.main, jbench, env, capsys)
    got = _line(tbench.main, tbench, env, capsys)
    if want[0] == "exit":
        assert got == want
        return
    assert got[0] == "line" and got[1].pop("device") == "cpu"
    assert got == want
    assert list(want[1]) == ["metric", "value", "unit", "vs_baseline"]


def test_the_baseline_table_is_the_reference(jbench):
    assert tbench.BASELINE_FPS_BY_SIZE == jbench.BASELINE_FPS_BY_SIZE
    assert tbench.BASELINE_FPS == jbench.BASELINE_FPS


# -- (b) flagship ----------------------------------------------------------------

def _plan(model) -> list:
    return [tuple(dataclasses.astuple(x) if dataclasses.is_dataclass(x) else x for x in op)
            for op in model.plan]


@pytest.mark.parametrize("kw", [{}, {"backbone": "darknet"}, {"backbone": "tiny"},
                                {"tiny": True}, {"backbone": "mobilenet"},
                                {"backbone": "mobilenet", "tiny": True}, {"num_classes": 80}])
def test_flagship_matches_the_reference(kw):
    """The port spells the reference's ``tiny=True`` ``backbone="tiny"``; a
    ``backbone`` given takes precedence, as in the reference."""
    from __graft_entry__ import _flagship

    port_kw = {k: v for k, v in kw.items() if k != "tiny"}
    if kw.get("tiny"):
        port_kw.setdefault("backbone", "tiny")
    want, got = _flagship(**kw), tentry.flagship(**port_kw)
    assert type(got).__name__ == type(want).__name__
    np.testing.assert_array_equal(np.asarray(got.anchors), np.asarray(want.anchors))
    assert got.num_classes == want.num_classes and got.pallas == want.pallas
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _plan(got) == _plan(want)


def test_flagship_refuses_an_unknown_backbone():
    with pytest.raises(ValueError, match="resnet"):
        tentry.flagship(backbone="resnet")


# -- (c) the detect closure ----------------------------------------------------

def _f32(monkeypatch):
    """Both packages' flagship in f32."""
    import __graft_entry__

    monkeypatch.setattr(__graft_entry__, "_flagship",
                        functools.partial(__graft_entry__._flagship, dtype=jnp.float32))
    monkeypatch.setattr(tbench, "flagship", functools.partial(tentry.flagship,
                                                               dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def _reference_init(backbone: str):
    """The reference's flagship init at ``PRNGKey(0)``, as numpy (f32 in any
    compute dtype)."""
    from __graft_entry__ import _flagship

    params, state = _flagship(backbone=backbone).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _reference_weights(backbone: str):
    return from_jax(*_reference_init(backbone))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_the_folded_model_carries_the_reference_bias(env, jbench, backbone):
    """At the bench density the objectness logit lands where the reference
    puts it: every folded bias equal, the head's included."""
    env.setenv("BENCH_MODEL", backbone)
    _f32(env)
    _, want, _, _ = jbench._make_infer_run(BATCH, SIZE)
    with one_thread(env):
        _, got, images = tbench.make_infer_run(BATCH, SIZE, "cpu", *_reference_weights(backbone))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name]["b"].numpy(), np.asarray(want[name]["b"]))
    head = got["out"]["b"].view(-1, 25)
    assert (head[:, 4] == tbench.OBJECTNESS).all() and not (head[:, :4] == tbench.OBJECTNESS).any()
    assert images.shape == (BATCH, SIZE, SIZE, 3)


@pytest.mark.parametrize("backbone,route", [("darknet", "fused"), ("darknet", "nms"),
                                            ("darknet", "plain"), ("tiny", "fused"),
                                            ("mobilenet", "fused")])
def test_the_detect_summary_matches_the_reference(env, jbench, backbone, route):
    from jax.experimental.pallas import tpu as pltpu

    env.setenv("BENCH_MODEL", backbone)
    env.setenv("BENCH_SATURATED", "1")
    if route == "nms":
        env.setenv("BENCH_PALLAS", "nms")
    if route == "plain":
        env.setattr(tinference, "kernel_active", lambda which, enabled: False)
    else:
        env.setattr(jmodels, "pallas_active", lambda which, enabled: which in enabled)
    _f32(env)
    with pltpu.force_tpu_interpret_mode():
        run, folded, images, _ = jbench._make_infer_run(BATCH, SIZE)
        want = float(run(folded, images))
    with one_thread(env):
        run, folded, got_images = tbench.make_infer_run(BATCH, SIZE, "cpu",
                                                        *_reference_weights(backbone))
        got = float(run(folded, got_images))
    np.testing.assert_array_equal(got_images.numpy(), np.asarray(images))
    assert want > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-5)


# -- (d) train ---------------------------------------------------------------------

class _Stepped(Exception):
    pass


def test_the_train_batch_and_step_match_the_reference(env, jbench):
    _f32(env)
    seen = {}

    def capture(*args, **kw):
        step = make(*args, **kw)

        def first(params, state, opt_state, data, n):
            seen.update(data=data, seen=int(n), out=step(params, state, opt_state, data, n))
            raise _Stepped

        return first

    make = jmesh.make_train_step
    env.setattr(jmesh, "make_train_step", capture)
    with pytest.raises(_Stepped):
        jbench.bench_train(BATCH, 1, SIZE)
    data = tbench.train_batch(BATCH, SIZE)
    assert set(data) == set(seen["data"])
    for k, v in data.items():
        want = np.asarray(seen["data"][k])
        assert v.dtype == want.dtype and v.shape == want.shape
        np.testing.assert_array_equal(v, want)

    with one_thread(env):
        step, carry, tdata, n = tbench.train_setup(BATCH, SIZE, "cpu",
                                                   *_reference_weights("darknet"))
        *_, metrics = step(*carry, tdata, n)
    assert n == seen["seen"]
    jm = seen["out"][3]
    for k in ("coord", "object", "noobject", "cls", "prior", "total"):
        np.testing.assert_allclose(metrics[k].item(), float(jm[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jm["grad_norm"]), rtol=5e-3)


# -- (e) e2e -------------------------------------------------------------------------

@pytest.mark.parametrize("devdata", [False, True], ids=["loader", "devdata"])
@pytest.mark.parametrize("decomp", [False, True], ids=["pipelined", "decomp"])
def test_e2e_runs_small_and_cleans_up(env, capsys, devdata, decomp):
    pytest.importorskip("cv2")
    roots = []
    mkdtemp = tbench.tempfile.mkdtemp

    def record(*a, **k):
        roots.append(mkdtemp(*a, **k))
        return roots[-1]

    env.setattr(tbench.tempfile, "mkdtemp", record)
    capsys.readouterr()
    with one_thread(env):
        rate = tbench.bench_e2e(BATCH, 2, devdata, decomp, n_images=8, size=SIZE, device="cpu",
                                model_ini=[ROOT / "config" / "tiny.ini"])
    assert math.isfinite(rate) and rate > 0
    assert len(roots) == 1 and not Path(roots[0]).exists()
    err = [line for line in capsys.readouterr().err.splitlines() if line.startswith("{")]
    if not decomp:
        assert not err
        return
    split = json.loads(err[-1])
    want = _dict_keys(ROOT / "bench.py", "e2e_decomposition_ms_per_batch")
    got = set(split) | set(split["e2e_decomposition_ms_per_batch"])
    assert got == want
    assert split["device_dataset"] is devdata and split["batch"] == BATCH
    assert (split["tunnel_wire_MB_per_s"] is None) is devdata


# -- (f) pipeline ----------------------------------------------------------------------

def test_pipeline_runs_small():
    pytest.importorskip("cv2")
    rate = tbench.bench_pipeline(4, 2, n_images=8)
    assert math.isfinite(rate) and rate > 0


@pytest.mark.parametrize("mode", ["pipeline", "e2e"])
def test_pipeline_and_e2e_refuse_without_opencv(env, mode):
    env.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="cv2"):
        if mode == "pipeline":
            tbench.bench_pipeline(4, 2, n_images=8)
        else:
            tbench.bench_e2e(BATCH, 2, n_images=8, size=SIZE, device="cpu")


# -- (g) sustained -----------------------------------------------------------------------

def test_sustained_bench_writes_the_reference_record(env, tmp_path, capsys):
    out = tmp_path / "deep" / "sustained.json"
    with one_thread(env):
        assert tsustained.main(["--round", "00", "--seconds", "0.5", "--batch", "1", "--size",
                                str(SIZE), "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert _dict_keys(ROOT / "scripts" / "sustained_bench.py", "in_graph_repeat") <= set(rec)
    assert rec["metric"] == f"sustained_infer_{SIZE}" and rec["in_graph_repeat"] == 1
    assert rec["window_rate_p5"] <= rec["window_rate_p50"] <= rec["window_rate_p95"]
    assert rec["windows"] >= 1 and rec["dispatches"] == rec["windows"] * 8
    assert rec["device"] == "cpu" and rec["batch"] == 1


def test_sustained_bench_refuses_no_seconds(env):
    with pytest.raises(SystemExit):
        tsustained.main(["--round", "00", "--seconds", "0"])


# -- (h) no fallback ------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["device", "main", "infer", "sustained"])
def test_cuda_without_a_card_raises(env, call):
    env.setenv("BENCH_DEVICE", "cuda")
    env.setattr(torch.cuda, "is_available", lambda: False)
    fns = {"device": tbench.bench_device, "main": tbench.main,
           "infer": lambda: tbench.make_infer_run(1, SIZE),
           "sustained": lambda: tsustained.main(["--round", "00", "--seconds", "1"])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fns[call]()
