"""The work the benchmark counts from layer shapes, against a count of the
port's own forward."""

from __future__ import annotations

import json

import pytest
import torch
import torch.nn.functional as F

from perfbench.harness import program, shapes
from perfbench.harness.cell import HERE

CONFIGS = {"darknet19-voc416": (14.680167424e9, 50.655389e6),
           "mobilenet-voc416": (7.185198592e9, 34.044989e6)}


def load(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_macs_and_params_match_the_hook_count(name):
    """14.680 / 7.185 GMAC an image at 416 and 50.66 / 34.04 M parameters,
    as a conv hook on the port's forward counted them."""
    macs, params = CONFIGS[name]
    cfg = load(name)
    assert shapes.forward_macs(cfg["plan"], 416) == pytest.approx(macs, rel=1e-9)
    assert shapes.param_count(cfg["plan"]) == pytest.approx(params, rel=1e-9)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_macs_match_a_hook_on_the_port_at_a_small_size(name, monkeypatch):
    cfg = dict(load(name), dtype="float32", pallas=[])
    model = program.build_model(cfg)
    params, state = model.init(torch.Generator().manual_seed(0))
    counted = []
    real = F.conv2d

    def hook(x, w, *args, **kw):
        y = real(x, w, *args, **kw)
        counted.append(y.shape[0] * y.shape[2] * y.shape[3] * w.numel())
        return y

    monkeypatch.setattr(F, "conv2d", hook)
    with torch.no_grad():
        model.apply_folded(model.fold(params, state), torch.rand(1, 96, 96, 3))
    assert sum(counted) == shapes.forward_macs(cfg["plan"], 96)


def test_routed_layers_and_kernel_bytes():
    cfg = load("mobilenet-voc416")
    routed = shapes.routed_layers(cfg["plan"], 416, cfg["pallas"])
    assert [d["name"] for d, _ in routed["dwsep"]] == [f"dw{i}" for i in range(7, 14)]
    assert [d["name"] for d in routed["dwconv"]] == ["dw3", "dw4", "dw5", "dw6"]
    work = shapes.kernel_work(cfg["plan"], 416, cfg["pallas"], 128)
    # dw3-dw6 at B=128: bf16 inputs and outputs read and written once
    flops, bytes_ = work["dwconv"]
    inputs = 104 * 104 * 128 * 2 + 52 * 52 * 256 * 2
    outputs = 104 * 104 * 128 + 52 * 52 * 128 + 52 * 52 * 256 + 26 * 26 * 256
    weights = 2 * 9 * (128 * 2 + 256 * 2) + 4 * (2 * 128 + 2 * 256)
    assert bytes_ == 2 * 128 * (inputs + outputs) + weights
    assert flops == 2 * 128 * 9 * (104 * 104 * 128 + 52 * 52 * 128 + 52 * 52 * 256 + 26 * 26 * 256)
    assert shapes.routed_layers(load("darknet19-voc416")["plan"], 416, ["nms", "fusedpost"]) == {
        "dwsep": [], "dwconv": []}
