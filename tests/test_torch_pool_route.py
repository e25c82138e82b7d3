"""The folded walk's max-pool rule (``models/engine.py::route``).

Every conv whose output feeds a 2×2 stride-2 pool of even H and W, directly
or through one ``mark``, hands its raw output and bias to
``kernels/pool.py::maxpool2x2`` under any ``[model] pallas`` tokens and at
any channel count, with ``full`` where the ``mark`` sits between them, and
the slot then holds the full-resolution epilogue output.  A pool that
follows no conv runs in the kernel bare, at any channel count and under any
tokens.  An odd H or W and a stride-1 pool keep ``bias_leaky_nhwc`` and
``max_pool``.  The pairs each model's route takes are pinned in
``tests/test_torch_route.py``.

On the CPU the wrapper runs its plain version, so the folded forward equals
the same walk with ``maxpool2x2_plain`` in its place exactly.  Calls are
recorded through ``monkeypatch`` alone.  On the card the route is held to the
plain pool in ``tests/test_torch_cuda_nms_pool_reorg.py``.
"""

import numpy as np
import pytest
import torch

from yolojax_torch.kernels import epilogue as ek
from yolojax_torch.kernels import pool as pk
from yolojax_torch.models import LayerDef, engine
from yolojax_torch.models.blocks import bias_leaky, conv, max_pool
from yolojax_torch.models.darknet import Darknet, Tiny

TOKENS = frozenset({"nms", "fusedpost"})
# full width at 64²
MODELS = {"darknet": Darknet, "tiny": Tiny}


def _folded(cls, dtype=torch.float32):
    """A full-width model on ``TOKENS`` and its folded weights, with random
    biases (BN's fresh state folds to zero)."""
    model = cls(anchors=np.ones((5, 2), np.float32), num_classes=20, dtype=dtype, pallas=TOKENS)
    folded = model.fold(*model.init(torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(1)
    for lp in folded.values():
        lp["b"] = torch.randn(lp["b"].shape, generator=g) * 0.5
    return model, folded


def _images(b=2, size=64):
    return torch.rand((b, size, size, 3), generator=torch.Generator().manual_seed(2))


def _record(monkeypatch, module, name, log):
    """Wrap ``module.name`` to log (its arguments, its result) per call."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.append((args, out))
        return out

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("name", MODELS)
def test_every_conv_pool_pair_takes_the_pool_kernel_with_its_bias(monkeypatch, name):
    model, folded = _folded(MODELS[name])
    # the convs whose output feeds a 2×2/2 pool, in plan order, with the mark's
    # full output where one sits between
    pairs = [(s.layer.name, s.key is not None)
             for s in engine.route(model.plan, pallas=model.pallas, reorg_order="darknet",
                                   dtype=model.dtype, channels=3, height=64, width=64)
             if s.kernel == "maxpool2x2"]
    assert pairs
    convs, pools, epilogues = [], [], []
    _record(monkeypatch, engine, "conv", convs)
    _record(monkeypatch, pk, "maxpool2x2", pools)
    _record(monkeypatch, ek, "bias_leaky_nhwc", epilogues)
    with torch.no_grad():
        model.apply_folded(folded, _images())
    layer = {id(w): n for n, lp in folded.items() for k, w in lp.items() if k in ("w", "w_pad")}
    raw = {layer[id(args[1])]: out for args, out in convs}
    assert len(pools) == len(pairs)
    for ((x, bias, act, full), out), (conv_name, want_full) in zip(pools, pairs):
        assert torch.equal(x, raw[conv_name].permute(0, 2, 3, 1))
        assert bias is folded[conv_name]["b"] and act is True and full is want_full
        assert isinstance(out, tuple) is want_full
    # every other conv's epilogue on the one-pass wrapper; each conv's once
    assert len(epilogues) == len(model.layer_defs) - len(pairs)
    if name == "darknet":
        # the s16 slot, which c21 reads, holds c13's full-resolution epilogue output
        (x13, b13, _, _), (_, full13) = pools[-1]
        c21_in = next(args[0] for args, _ in convs if args[1] is folded["c21"]["w"])
        assert torch.equal(c21_in.permute(0, 2, 3, 1), full13)
        assert torch.equal(full13, ek.bias_leaky_nhwc_plain(x13, b13))


# (plan of one conv ``d`` and one pool, input NHWC shape, pallas tokens): a 2×2/2
# pool over an even H and W after no conv takes the bare kernel, at any C and
# under any tokens
UNFUSED = {
    "odd-h": (lambda d: [("conv", d), ("pool", 2, 2)], (1, 5, 6, 3), TOKENS),
    "odd-w": (lambda d: [("conv", d), ("pool", 2, 2)], (1, 6, 5, 3), TOKENS),
    "stride-1": (lambda d: [("conv", d), ("pool", 2, 1)], (1, 6, 6, 3), TOKENS),
    "after-no-conv": (lambda d: [("pool", 2, 2), ("conv", d)], (1, 6, 6, 128), TOKENS),
    "after-no-conv-pool-token": (lambda d: [("pool", 2, 2), ("conv", d)], (1, 6, 6, 128),
                                 TOKENS | {"pool"}),
    "after-no-conv-narrow": (lambda d: [("pool", 2, 2), ("conv", d)], (1, 6, 6, 64),
                             TOKENS | {"pool"}),
}


@pytest.mark.parametrize("case", UNFUSED)
def test_pools_the_kernel_does_not_fuse_keep_bias_leaky_and_max_pool(rng, monkeypatch, case):
    plan_of, shape, pallas = UNFUSED[case]
    d = LayerDef("c", 16, 3)
    plan = plan_of(d)
    engine.resolve_in_channels(plan, shape[-1])
    w = torch.from_numpy(rng.standard_normal((16, shape[-1], 3, 3)).astype(np.float32) * 0.2)
    folded = {"c": {"w": w, "b": torch.from_numpy(rng.normal(0, 0.5, 16).astype(np.float32))}}
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    pools, max_pools, epilogues = [], [], []
    _record(monkeypatch, pk, "maxpool2x2", pools)
    _record(monkeypatch, engine, "max_pool", max_pools)
    _record(monkeypatch, ek, "bias_leaky_nhwc", epilogues)
    got = engine.run_plan(plan, folded, x, compute_dtype=torch.float32, pallas=pallas)

    y = x.permute(0, 3, 1, 2)
    bare = case.startswith("after-no-conv")
    for op in plan:
        if op[0] == "conv":
            y = bias_leaky(conv(y, w), folded["c"]["b"])
        else:
            y = max_pool(y, op[1], op[2])
    assert torch.equal(got, y.permute(0, 2, 3, 1))
    assert len(epilogues) == 1
    assert [len(args) for args, _ in pools] == ([1] if bare else [])
    assert len(max_pools) == (0 if bare else 1)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_forward_equals_the_walk_with_the_plain_pool(monkeypatch, name, dtype):
    model, folded = _folded(MODELS[name], dtype)
    x = _images()
    with torch.no_grad():
        got = model.apply_folded(folded, x)
        monkeypatch.setattr(pk, "maxpool2x2", pk.maxpool2x2_plain)
        want = model.apply_folded(folded, x)
    assert got.dtype == dtype and got.shape == (2, 2, 2, 125)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
