"""The port's prune → finetune → recover gate (``yolojax_torch/tools/prune_gate.py``)
against the JAX package's (``scripts/prune_gate.py``).

* the flags: ``python scripts/prune_gate.py --help`` in a subprocess gives
  the reference's options and which take a value; the port has the same
  plus ``--device``, with the same types and defaults but ``--root`` (the
  port's Darknet gate workspace) and ``--out`` (the port's artifact);
* ``--sparsity`` without ``--fresh`` is refused with the reference's
  message (the defaults alone are refused too, as in the reference);
* a ``--fresh`` chain on the CPU: Darknet-19 at full width, 12 images, the
  gate's overlay and a test overlay (f32, batch 2, eval batch 6), the
  source pinned to 64² (``SIZE``) for 4 steps with sparsity 0.01, prune at
  0.4, 2 finetune steps, ``--scratch-control`` and one sweep λ.  The
  artifact has the reference's keys plus ``device``, ``eval_launches`` and
  ``stage_seconds``; the finetune's milestones, its last step and the
  scratch control's are the reference's arithmetic; ``pass`` is the frozen
  criterion applied to the artifact's numbers;
* that chain's dense checkpoint through both packages' ``cli/prune.py``:
  the same ``channels.json`` and the same pruned tensors, bit for bit;
* the dense, pruned and finetuned checkpoints through both packages'
  ``run_eval`` at 64/stretch, f32: mAP within 1e-6;
* ``--device cuda`` raises where there is no card.
"""

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from yolojax_torch.tools import prune_gate as gate

from torch_port_families import one_thread

ROOT = Path(__file__).resolve().parents[1]
SIZE = 64
STEPS, FINETUNE_STEPS, IMAGES, RATIO = 4, 2, 12, 0.4


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference(monkeypatch):
    """``scripts/prune_gate.py`` as a module; its sibling import
    ``synth_gate`` is the JAX gate, loaded by path."""
    monkeypatch.setitem(sys.modules, "synth_gate",
                        _load("jax_synth_gate", ROOT / "scripts" / "synth_gate.py"))
    return _load("jax_prune_gate", ROOT / "scripts" / "prune_gate.py")


class _Parsed(Exception):
    pass


def _reference_parser(monkeypatch):
    """The parser the reference's ``main`` builds, caught at ``parse_args``."""
    import argparse

    ref = _reference(monkeypatch)

    def catch(self, *a, **k):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as got:
        ref.main()
    monkeypatch.undo()
    return got.value.args[0]


def _options(parser) -> dict:
    return {a.option_strings[-1]: a for a in parser._actions if a.dest != "help"}


def test_the_flags_and_defaults_are_the_reference_s(monkeypatch):
    text = subprocess.run([sys.executable, str(ROOT / "scripts" / "prune_gate.py"), "--help"],
                          capture_output=True, text=True, check=True, cwd=ROOT).stdout
    usage = text[:text.index("options:")]
    flags = dict(re.findall(r"\[(--[a-z-]+)( [A-Z_]+)?\]", usage))
    assert len(flags) == 12
    ours = _options(gate.gate_parser())
    assert set(ours) == set(flags) | {"--device"}
    for flag, metavar in flags.items():
        assert (ours[flag].nargs == 0) == (metavar == ""), flag

    theirs = _options(_reference_parser(monkeypatch))
    assert set(theirs) == set(flags)
    for flag, action in theirs.items():
        assert type(ours[flag]) is type(action) and ours[flag].type is action.type, flag
        if flag not in ("--root", "--out"):
            assert ours[flag].default == action.default, flag
    assert ours["--root"].default == str(ROOT / "build" / "synth_gate_torch")
    assert ours["--out"].default == "SYNTH_GATE_TORCH_PRUNE.json"
    assert ours["--device"].default == "cuda"


@pytest.mark.parametrize("argv", [[], ["--sparsity", "0.01"], ["--sparsity", "0.05",
                                                                "--skip-finetune"]])
def test_sparsity_without_fresh_is_refused_as_in_the_reference(monkeypatch, capsys, argv):
    ref = _reference(monkeypatch)
    errors = []
    for run in (lambda: gate.main(argv), lambda: ref.main()):
        monkeypatch.setattr(sys, "argv", ["prune_gate.py", *argv])
        with pytest.raises(SystemExit) as exit_:
            run()
        assert exit_.value.code == 2
        errors.append(capsys.readouterr().err.split("error: ", 1)[1])
    assert errors[0] == errors[1]
    assert errors[0].startswith("--sparsity only takes effect with --fresh")


TEST_OVERLAY = """[model]
dtype = float32
[data]
batch_size = 2
device_dataset = 0
workers = 2
[train]
prewarm = 0
[transform]
dtype = float32
[eval]
batch_size = 6
"""


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("prune_gate")
    overlay = root / "test.ini"
    overlay.write_text(TEST_OVERLAY)
    out = root / "artifact.json"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gate, "SIZE", SIZE)
        with one_thread(mp):
            rc = gate.main(["--fresh", "--root", str(root / "ws"), "--images", str(IMAGES),
                            "--steps", str(STEPS), "--finetune-steps", str(FINETUNE_STEPS),
                            "--ratio", str(RATIO), "--scratch-control", "--sweep", "0.05",
                            "--device", "cpu", "--out", str(out)], extra_cfg=[str(overlay)])
        # the chain's own config list: the pins at SIZE
        cfg = ["-c", str(ROOT / "config.ini"), str(root / "ws" / "gate.ini"), str(overlay),
               *gate.pins(0.01)]
    return root, rc, json.loads(out.read_text()), cfg


def _model_dir(cfg, name: str) -> Path:
    from yolojax_torch import cli
    from yolojax_torch.config import get_model_dir

    config = cli.setup(cli.make_parser("x").parse_args(cfg + ["-m", f"model/name={name}"]))
    return Path(get_model_dir(config))


def _last_step(cfg, name: str) -> int:
    from yolojax_torch.utils import checkpoint as ckpt

    _, meta = ckpt.load(ckpt.latest(str(_model_dir(cfg, name))), ())
    return int(meta["step"])


def test_the_fresh_chain_runs_on_the_cpu(chain):
    root, rc, art, cfg = chain
    reference = json.loads((ROOT / "SYNTH_GATE_PRUNE.json").read_text())
    assert set(art) == set(reference) | {"device", "eval_launches", "stage_seconds"}
    assert set(art["finetune"]) == set(reference["finetune"])
    assert set(art["scratch_control"]) == set(reference["scratch_control"])
    assert [set(s) for s in art["sparsity_sweep"]] == [set(reference["sparsity_sweep"][0])] * 2

    total = STEPS + FINETUNE_STEPS
    assert art["source"]["step"] == STEPS and art["sparsity"] == 0.01
    assert art["finetune"]["steps"] == FINETUNE_STEPS
    assert art["finetune"]["milestones"] == [STEPS + int(FINETUNE_STEPS * 0.6),
                                             STEPS + int(FINETUNE_STEPS * 0.9)]
    ft_step = _last_step(cfg, "synthgate_darknet_voc_pruned")
    assert ft_step == total
    assert _last_step(cfg, "synthgate_darknet_voc_scratch") == FINETUNE_STEPS
    assert _last_step(cfg, "synthgate_darknet_voc_sw0p05") == STEPS
    assert art["scratch_control"]["milestones"] == [int(FINETUNE_STEPS * 0.6),
                                                    int(FINETUNE_STEPS * 0.9)]
    assert [s["sparsity"] for s in art["sparsity_sweep"]] == [0.01, 0.05]
    assert art["sparsity_sweep"][1]["source"] == f"sw0p05 ({STEPS} steps, same cache)"

    maps = [art["map_dense_416"], art["map_pruned_416"], art["map_finetuned_416"],
            art["scratch_control"]["map_scratch_416"]]
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in maps)
    assert art["criteria"] == {"max_recovery_deficit": 0.03}
    want = (art["map_finetuned_416"] >= art["map_dense_416"] - 0.03) and ft_step >= total
    assert art["pass"] == want and rc == (0 if want else 1)
    assert art["recovery_delta"] == round(art["map_finetuned_416"] - art["map_dense_416"], 4)

    dense = json.loads((root / "ws" / "pruned" / "channels.json").read_text())
    assert art["channels_kept"] == sum(dense.values())
    assert art["device"]["device"] == "cpu" and art["device"]["dtype"] == "float32"
    assert set(art["eval_launches"]) == {"dense", "pruned", "finetuned", "scratch",
                                         "sw0p05_dense", "sw0p05_pruned"}
    assert {"data", "cache", "anchors", "train_source", "prune", "train_finetune",
            "train_scratch", "train_sw0p05", "eval_dense"} <= set(art["stage_seconds"])


def test_the_dense_checkpoint_prunes_as_in_the_reference(chain, tmp_path):
    from yolojax.cli.prune import main as jprune_main
    from yolojax_torch.utils import checkpoint as ckpt

    root, _, art, cfg = chain
    assert jprune_main(cfg + ["--ratio", str(RATIO), "-o", str(tmp_path)]) == 0
    ours = root / "ws" / "pruned"
    assert (json.loads((tmp_path / "channels.json").read_text())
            == json.loads((ours / "channels.json").read_text()))
    name = f"{art['source']['step']}.npz"
    want, want_meta = ckpt.load(str(tmp_path / name), ("params", "state"))
    got, got_meta = ckpt.load(str(ours / name), ("params", "state"))
    assert got_meta["channels"] == want_meta["channels"]
    assert got_meta["step"] == want_meta["step"] == STEPS
    leaves = 0
    for tree in ("params", "state"):
        assert set(got[tree]) == set(want[tree])
        for layer, values in want[tree].items():
            for key, v in values.items():
                np.testing.assert_array_equal(np.asarray(got[tree][layer][key]), np.asarray(v),
                                              err_msg=f"{tree} {layer} {key}")
                leaves += 1
    assert leaves > 50


@pytest.mark.parametrize("which", ["dense", "pruned", "finetuned"])
def test_each_checkpoint_evaluates_to_the_reference_map(chain, which):
    """The chain's checkpoints through both packages' ``run_eval`` at 64/stretch,
    f32: the same mAP to 1e-6."""
    from yolojax import cli as jcli
    from yolojax.cli.common import build as jbuild
    from yolojax.cli.common import load_weights_auto as jload
    from yolojax.cli.eval import run_eval as jrun_eval
    from yolojax.data.cache import load_cache as jload_cache
    from yolojax_torch import cli
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.eval import run_eval
    from yolojax_torch.data.cache import load_cache

    root, _, art, cfg = chain
    channels = ["-m", f"model/channels={root / 'ws' / 'pruned' / 'channels.json'}"]
    extra, fil = {"dense": ([], None),
                  "pruned": (channels, str(root / "ws" / "pruned" / f"{STEPS}.npz")),
                  "finetuned": (channels + ["-m", "model/name=synthgate_darknet_voc_pruned"],
                                None)}[which]
    jconfig = jcli.setup(jcli.make_parser("eval").parse_args(cfg + extra))
    config = cli.setup(cli.make_parser("eval").parse_args(cfg + extra))
    maps = []
    for c, setup_fns in ((jconfig, (jbuild, jload, jload_cache, jrun_eval)),
                         (config, (build, load_weights_auto, load_cache, run_eval))):
        build_fn, load_fn, cache_fn, eval_fn = setup_fns
        c.set("transform", "resize", "yolojax.data.transform.stretch")
        category, _, model = build_fn(c)
        params, state, meta = load_fn(c, model, fil, resume=fil is None)
        r = eval_fn(c, model, params, state, cache_fn(c, "test"), SIZE, 6, category)
        maps.append(r["map"])
    assert abs(maps[0] - maps[1]) <= 1e-6, maps
    key = {"dense": "map_dense_416", "pruned": "map_pruned_416",
           "finetuned": "map_finetuned_416"}[which]
    assert art[key] == round(maps[1], 4)


def test_the_gate_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gate.main(["--fresh", "--root", str(tmp_path / "ws"), "--out", str(tmp_path / "a.json")])
    assert not (tmp_path / "ws").exists() and not (tmp_path / "a.json").exists()
