"""Port parity, pruning: ``yolojax_torch.tools.prune`` and
``yolojax_torch.cli.prune`` against ``yolojax.tools.prune`` and
``yolojax.cli.prune`` on the CPU in f32 at 64² with the same weights
(``checkpoint.from_jax``), γ spread over U(0, 1.5) so the ranking cuts.

Tolerances: slicing moves values and computes nothing, so the pruned arrays
equal the reference's exactly, and so do the channel dict and
``gamma_concentration`` (the same f32 |γ| ranked by the same numpy code);
the pruned forward within rtol/atol 1e-3 of the JAX pruned forward, the f32
bound ``tests/test_torch_models.py`` holds the raw head to.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolojax.cli.common as jcommon
from yolojax.tools import prune as jprune
from yolojax_torch.cli import common as tcommon
from yolojax_torch.cli import prune as tprune_cli
from yolojax_torch.models.inference import Inference
from yolojax_torch.tools import prune as tprune
from yolojax_torch.utils import checkpoint as ckpt

from torch_port_families import ROOT, both, family_config, narrow_config

GAMMA = (0.0, 1.5)


def pruned_both(rng, family, ratio, config=None):
    config = config or family_config(family)
    jmodel, (jp, js), model, (p, s) = both(config, rng, gamma=GAMMA)
    want = jprune.prune(jmodel, jp, js, ratio)
    got = tprune.prune(model, p, s, ratio)
    return jmodel, model, (jp, js, p, s), got, want


@pytest.mark.parametrize("family", ["darknet", "darknet-s2d", "tiny", "mobilenet"])
@pytest.mark.parametrize("ratio,narrow", [(0.3, False), (0.6, True)], ids=["full", "narrow"])
def test_prune_equals_the_reference(rng, family, ratio, narrow):
    config = narrow_config(family) if narrow else None
    jmodel, model, (jp, js, p, s), got, want = pruned_both(rng, family, ratio, config)
    assert got[2] == want[2] and len(got[2]) > 0
    gp, gs = ckpt.to_jax(got[0], got[1])
    for tree, ref in ((gp, want[0]), (gs, want[1])):
        assert tree.keys() == ref.keys()
        for layer in ref:
            assert tree[layer].keys() == ref[layer].keys()
            for name, v in ref[layer].items():
                np.testing.assert_array_equal(tree[layer][name], np.asarray(v),
                                              err_msg=f"{layer}.{name}")
    assert tprune.gamma_concentration(model, p, ratio) == jprune.gamma_concentration(
        jmodel, jp, ratio)


def test_darknet_order_keeps_the_reorg_feeder_at_full_width(rng):
    _, model, _, (params, _, channels), _ = pruned_both(rng, "darknet", 0.6)
    assert "c21" not in channels and params["c21"]["w"].shape[0] == 64
    _, model, _, (params, _, channels), _ = pruned_both(rng, "darknet-s2d", 0.6)
    assert channels["c21"] < 64


def test_rank_threshold_keeps_ties():
    gammas = np.asarray([0.0] * 6 + [1.0, 2.0, 3.0, 4.0], np.float32)
    for ratio in (0.3, 0.5, 0.6, 0.9):
        assert tprune._rank_threshold(gammas, ratio) == jprune._rank_threshold(gammas, ratio)
    # the tie run at 0 is kept whole: asking for 3 removals removes none
    assert tprune._rank_threshold(gammas, 0.3) == 0.0


@pytest.mark.parametrize("family", ["darknet-s2d", "mobilenet"])
def test_pruned_forward_matches_the_jax_pruned_forward(rng, family, tmp_path):
    """From narrow widths (the JAX package compiles the forward), pruned
    again: the channels file holds every pruned layer's width."""
    narrow = narrow_config(family)
    jmodel, model, _, got, want = pruned_both(rng, family, 0.3, narrow)
    path = tmp_path / "channels.json"
    widths = json.loads(open(narrow.get("model", "channels")).read())
    tprune.save_channels(str(path), {**widths, **got[2]})
    config = family_config(family, f"model/channels={path}")
    _, _, jpruned = jcommon.build(config)
    _, _, pruned = tcommon.build(config)
    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    want_raw = np.asarray(jpruned.apply_folded(jpruned.fold(*want[:2]), jnp.asarray(images)))
    got_raw = pruned.apply_folded(pruned.fold(got[0], got[1]), torch.from_numpy(images))
    assert got_raw.shape == want_raw.shape
    np.testing.assert_allclose(got_raw.numpy(), want_raw, rtol=1e-3, atol=1e-3)


def test_prune_cli_round_trip(rng, tmp_path):
    """cli.prune on a checkpoint → channels.json + <step>.npz; the model
    rebuilt with -m model/channels loads that npz and detects; the JAX
    package's CLI, given the same checkpoint, writes the same files."""
    config = family_config("tiny")
    jmodel, (jp, js), _, _ = both(config, rng, gamma=GAMMA)
    src = tmp_path / "7.npz"
    ckpt.save(str(src), {"params": jp, "state": js}, {"step": 7, "seen": 56})
    args = ["-c", str(ROOT / "config.ini"), str(ROOT / "config" / "tiny.ini"), "-m",
            "model/dtype=float32", "data/sizes=64,64", f"config/root={tmp_path}", "-f", str(src),
            "--ratio", "0.3"]
    assert tprune_cli.main(args + ["-o", str(tmp_path / "port")]) == 0
    from yolojax.cli import prune as jprune_cli

    assert jprune_cli.main(args + ["-o", str(tmp_path / "jax")]) == 0
    channels = json.loads((tmp_path / "port" / "channels.json").read_text())
    assert channels == json.loads((tmp_path / "jax" / "channels.json").read_text())
    trees, meta = ckpt.load(str(tmp_path / "port" / "7.npz"))
    jtrees, jmeta = ckpt.load(str(tmp_path / "jax" / "7.npz"))
    assert meta == jmeta and meta["channels"] == channels and meta["step"] == 7
    for tree in ("params", "state"):
        for layer, leaves in jtrees[tree].items():
            for name, v in leaves.items():
                np.testing.assert_array_equal(trees[tree][layer][name], v)

    pruned_config = family_config("tiny", f"model/channels={tmp_path / 'port' / 'channels.json'}")
    _, _, model = tcommon.build(pruned_config)
    params, state, meta = tcommon.load_weights_auto(pruned_config, model,
                                                    str(tmp_path / "port" / "7.npz"))
    assert meta["step"] == 7 and params["c1"]["w"].shape[0] == channels["c1"]
    inf = Inference(model)
    out = inf.detect_fn(0.01, 0.45, 5)(inf.fold(params, state),
                                       torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3))
                                                        .astype(np.float32)))
    assert out.conf.shape == (2, 20, 5) and torch.isfinite(out.conf).all()
