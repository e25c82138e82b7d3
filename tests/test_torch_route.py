"""The folded walk's route (``models/engine.py::route``) and the launches of
a detect call read from it (``models/inference.py::Inference.launches``).

One table pins the kernel launches of one detect call on every path the
benchmark, the smoke run and the configs take, at full width: the forward's
(``maxpool2x2``, ``reorg_s2d``, ``bias_leaky_nhwc``, ``dwconv3x3``,
``dwsep``) and the post step's (``postprocess_fused``, ``nms_select``,
``tree_decode``, two launches a call), and the conv the route runs at a
padded width (``engine.padded_width``: the head, whose width is not a
multiple of 8).  Each case checks that the route gives the table, and that
the walk a detect call runs, with every kernel wrapper, cuDNN conv and
torch pool or reorg spied, calls exactly the route's steps, layer for
layer, each conv at the route's width, and no kernel the route does not
list.  The convolutions and depthwise kernels are replaced by zeros of
their output shapes (the route depends on the shapes alone), so a
full-size walk costs little on the CPU.  A plan of its own holds the
padding rule to the convs it names, and the padded walk's output to the
unpadded walk's on Darknet-19 and YOLO9000.
"""

import numpy as np
import pytest
import torch

from yolojax_torch.entry import flagship
from yolojax_torch.kernels import dwconv as dk
from yolojax_torch.kernels import dwsep as sk
from yolojax_torch.kernels import epilogue as ek
from yolojax_torch.kernels import nms as nk
from yolojax_torch.kernels import pool as pk
from yolojax_torch.kernels import postprocess_fused as fk
from yolojax_torch.kernels import reorg as rk
from yolojax_torch.kernels import tree as tk
from yolojax_torch.models import LayerDef, engine
from yolojax_torch.models.blocks import bias_leaky, conv, max_pool
from yolojax_torch.models.inference import Inference

DW = {"nms", "fusedpost", "dwconv", "dwsep"}
# VOC's head: 5 anchors × (5 + 20) = 125 channels, run at 128
VOC_HEAD = ("out", 128)
# (backbone, pallas tokens, reorg order, input size) -> (launches of one detect call,
# the padded convs: (layer, width)).
# Tiny at 400: c5's output is 25×25, so its pool takes max_pool after the epilogue;
# MobileNet at 672: the 26-row layers have 42 rows, over the dwsep gate's 40;
# YOLO9000's head: 3 × (5 + 9 418) = 28 269 channels, run at 28 272
TABLE = {
    "darknet": (("darknet", {"nms", "fusedpost"}, "darknet", 416),
                {"maxpool2x2": 5, "bias_leaky_nhwc": 18, "postprocess_fused": 1}, [VOC_HEAD]),
    "darknet-nms": (("darknet", {"nms"}, "darknet", 416),
                    {"maxpool2x2": 5, "bias_leaky_nhwc": 18, "nms_select": 1}, [VOC_HEAD]),
    "darknet-s2d": (("darknet", {"nms", "pool", "reorg"}, "s2d", 416),
                    {"maxpool2x2": 5, "reorg_s2d": 1, "bias_leaky_nhwc": 17, "nms_select": 1},
                    [VOC_HEAD]),
    "tiny": (("tiny", {"nms", "fusedpost", "pool"}, "darknet", 416),
             {"maxpool2x2": 5, "bias_leaky_nhwc": 4, "postprocess_fused": 1}, [VOC_HEAD]),
    "tiny-400": (("tiny", {"nms", "fusedpost", "pool"}, "darknet", 400),
                 {"maxpool2x2": 4, "bias_leaky_nhwc": 5, "postprocess_fused": 1}, [VOC_HEAD]),
    "mobilenet": (("mobilenet", DW, "darknet", 416),
                  {"dwconv3x3": 4, "dwsep": 7, "bias_leaky_nhwc": 14, "postprocess_fused": 1},
                  [VOC_HEAD]),
    "mobilenet-672": (("mobilenet", DW, "darknet", 672),
                      {"dwconv3x3": 10, "dwsep": 1, "bias_leaky_nhwc": 20,
                       "postprocess_fused": 1}, [VOC_HEAD]),
    "mobilenet-plain": (("mobilenet", {"nms", "fusedpost"}, "darknet", 416),
                        {"bias_leaky_nhwc": 32, "postprocess_fused": 1}, [VOC_HEAD]),
    "yolo9000": (("yolo9000", {"nms", "fusedpost"}, "darknet", 544),
                 {"maxpool2x2": 5, "bias_leaky_nhwc": 14, "tree_decode": 2}, [("out", 28272)]),
}
# the torch calls a step without a kernel makes
TORCH_CALLS = {"conv": "conv", "pool": "max_pool", "reorg": "reorg"}


def _model(name):
    (backbone, pallas, order, size), _, _ = TABLE[name]
    model = flagship(backbone=backbone)
    model.pallas, model.reorg_order = frozenset(pallas), order
    return model, size


def _folded(model):
    """Zero weights that allocate nothing beyond the biases and the padded
    head's ``w_pad``, with the layouts the walk reads."""
    folded = {d.name: {"w": torch.zeros(()).expand(d.out_ch, d.in_ch // d.groups, d.ksize,
                                                   d.ksize),
                       "b": torch.zeros(d.out_ch)} for d in model.layer_defs}
    engine.add_kernel_weights(model.plan, folded, model.pallas)
    return folded


def _zeros_conv(x, w, *, stride=1, groups=1):
    h, wd = ((n - 1) // stride + 1 for n in x.shape[2:])
    return x.new_zeros((x.shape[0], w.shape[0], h, wd)).contiguous(
        memory_format=torch.channels_last)


def _route(name):
    model, size = _model(name)
    return engine.route(model.plan, pallas=model.pallas, reorg_order=model.reorg_order,
                        dtype=model.dtype, channels=3, height=size, width=size)


def _zeros_dwconv(x, w, b, stride=1, act=True):
    b_, h, wd, c = x.shape
    return x.new_zeros((b_, (h - 1) // stride + 1, (wd - 1) // stride + 1, c))


def _zeros_dwsep(x, wd, bd, wp, bp, stride=1, wp_t=None):
    b_, h, w, _ = x.shape
    return x.new_zeros((b_, (h - 1) // stride + 1, (w - 1) // stride + 1, wp.shape[1]))


def _spied_detect(monkeypatch, model, folded, size):
    """One detect call with every wrapper and torch op of the walk spied:
    returns its calls in order as (name, the layer whose weight, taps or
    bias it was handed, or None), and each conv's (layer, output width)."""
    layer = {id(v): name for name, lp in folded.items() for v in lp.values()}
    calls, widths = [], []

    def zeros_conv(x, w, **kwargs):
        widths.append((layer[id(w)], w.shape[0]))
        return _zeros_conv(x, w, **kwargs)

    def spy(module, name, fn=None):
        fn = fn or getattr(module, name)

        def call(*args, **kwargs):
            calls.append((name, next((layer[id(a)] for a in args if id(a) in layer), None)))
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, call)

    spy(engine, "conv", zeros_conv)
    spy(engine, "max_pool")
    spy(engine, "reorg")
    spy(dk, "dwconv3x3", _zeros_dwconv)
    spy(sk, "dwsep", _zeros_dwsep)
    for module, name in ((ek, "bias_leaky_nhwc"), (pk, "maxpool2x2"), (rk, "reorg_s2d"),
                         (nk, "nms_select")):
        spy(module, name)
    for module, name in ((fk, "postprocess_fused"), (tk, "tree_decode")):
        spy(module, name, lambda *args: None)
    with torch.no_grad():
        Inference(model).detect_fn(0.005, 0.45, 10)(folded, torch.zeros(1, size, size, 3))
    return calls, widths


@pytest.mark.parametrize("name", TABLE)
def test_route_gives_the_table_and_the_walk_runs_the_route(monkeypatch, name):
    model, size = _model(name)
    _, want, padded = TABLE[name]
    inference = Inference(model)
    assert inference.launches(size) == want
    steps = _route(name)
    # one padded conv a call, the head, whose epilogue bias_leaky_nhwc takes
    assert [(s.layer.name, s.arg) for s in steps if s.op == "conv" and s.arg] == padded
    assert [s.kernel for s in steps if s.layer and s.layer.name == "out"] == [None,
                                                                               "bias_leaky_nhwc"]
    post = {k: v for k, v in want.items() if k in ("postprocess_fused", "nms_select",
                                                    "tree_decode")}
    assert engine.launches(steps) == {k: v for k, v in want.items() if k not in post}
    assert inference.launches(size, post=False) == engine.launches(steps)
    # every conv's epilogue runs once: on the wrapper or in the kernel that takes it
    layers = [s.layer.name for s in steps if s.op != "conv" and s.layer is not None]
    layers += [s.arg.name for s in steps if s.op == "dwsep"]
    assert sorted(layers) == sorted(d.name for d in model.layer_defs)

    calls, widths = _spied_detect(monkeypatch, model, _folded(model), size)
    walk = [(s.kernel or TORCH_CALLS[s.op], s.layer and s.layer.name) for s in steps
            if s.kernel or s.op in TORCH_CALLS]
    assert calls == walk + [(k, None) for k in post]     # one call of the post kernel
    assert widths == [(s.layer.name, s.arg or s.layer.out_ch) for s in steps if s.op == "conv"]
    got = {}
    for kernel, _ in calls:
        if kernel not in TORCH_CALLS.values():
            got[kernel] = got.get(kernel, 0) + (2 if kernel == "tree_decode" else 1)
    assert got == want


# the fused pools of a forward at 416: (conv, its raw output's (C, H, W), the
# slot its full output goes to)
POOLED = {"darknet-s2d": [("c1", (32, 416, 416), None), ("c2", (64, 208, 208), None),
                          ("c5", (128, 104, 104), None), ("c8", (256, 52, 52), None),
                          ("c13", (512, 26, 26), "s16")],
          "tiny": [("c1", (16, 416, 416), None), ("c2", (32, 208, 208), None),
                   ("c3", (64, 104, 104), None), ("c4", (128, 52, 52), None),
                   ("c5", (256, 26, 26), None)]}


@pytest.mark.parametrize("name", POOLED)
def test_route_steps_carry_the_symbolic_shapes(name):
    """At 416 each fused pool takes its conv's raw output; in Darknet-s2d the
    reorg kernel takes c21's with the concat, and c22 reads the 1280
    channels of the concat at 13×13."""
    model, size = _model(name)
    steps = engine.route(model.plan, pallas=model.pallas, reorg_order=model.reorg_order,
                         dtype=torch.bfloat16, channels=3, height=size, width=size)
    pools = [(s.layer.name, s.shape, s.key) for s in steps if s.kernel == "maxpool2x2"]
    assert pools == POOLED[name]
    if name == "tiny":      # c6's stride-1 pool: max_pool, 13×13 kept
        assert [(s.op, s.kernel, s.shape, s.arg) for s in steps if s.layer is None] == \
            [("pool", None, (512, 13, 13), (2, 1))]
        return
    (reorg,) = [s for s in steps if s.op == "reorg"]
    assert (reorg.layer.name, reorg.shape, reorg.key, reorg.arg) == ("c21", (64, 26, 26),
                                                                     "top", 2)
    conv_in = {s.layer.name: s.shape for s in steps if s.op == "conv"}
    assert conv_in["c22"] == (1280, 13, 13) and conv_in["out"] == (1024, 13, 13)
    assert [s.op for s in steps if s.layer is None] == ["mark", "load"]


def test_resolve_in_channels_reads_the_walk():
    plan = [("conv", LayerDef("a", 8, 3)), ("mark", "s"), ("pool", 2, 2),
            ("conv", LayerDef("dw", 8, 3, groups=-1)), ("reorg", 2), ("concat", "s"),
            ("load", "s"), ("conv", LayerDef("b", 4, 1))]
    engine.resolve_in_channels(plan, 3)
    assert [(op[1].in_ch, op[1].groups) for op in plan if op[0] == "conv"] == \
        [(3, 1), (8, 8), (8, 1)]
    shapes = engine._walk(plan, 3, 10, 6)
    assert shapes[4] == (8, 5, 3) and shapes[5] == (32, 2, 1) and shapes[6] == (40, 2, 1)
    assert shapes[8] == (4, 10, 6)
    with pytest.raises(ValueError, match="unknown plan op"):
        engine.route([("upsample", 2)], pallas=frozenset(), reorg_order="darknet",
                     dtype=torch.float32, channels=3, height=4, width=4)


@pytest.mark.parametrize("dtype,paired", [(torch.float32, 1), (torch.bfloat16, 0)])
def test_route_reads_the_bf16_channel_cap(dtype, paired):
    """A 2048-channel depthwise pair at 13 rows: dwsep in f32, the depthwise
    kernel and a cuDNN 1×1 conv in bf16."""
    plan = [("conv", LayerDef("dw", 2048, 3, groups=2048, in_ch=2048)),
            ("conv", LayerDef("pw", 64, 1, in_ch=2048))]
    steps = engine.route(plan, pallas=frozenset(DW), reorg_order="darknet", dtype=dtype,
                         channels=2048, height=13, width=13)
    assert engine.launches(steps) == ({"dwsep": 1} if paired else
                                      {"dwconv3x3": 1, "bias_leaky_nhwc": 1})


@pytest.mark.parametrize("height", [8, 7])
def test_only_convs_whose_epilogue_is_the_wrapper_and_width_off_8_are_padded(height):
    """At 8² c's 2×2 pool takes its epilogue, at 7² ``max_pool`` does not:
    then c (13 channels) runs at 16; the depthwise conv (13 channels, on
    cuDNN: not lane-aligned) and the convs of 128 and 16 channels never pad."""
    plan = [("conv", LayerDef("a", 125, 3)), ("conv", LayerDef("b", 128, 1)),
            ("conv", LayerDef("c", 13, 3)), ("pool", 2, 2),
            ("conv", LayerDef("dw", 13, 3, groups=-1)), ("conv", LayerDef("e", 16, 1)),
            ("conv", LayerDef("f", 3, 1, bn=False, act=False))]
    engine.resolve_in_channels(plan, 3)
    steps = engine.route(plan, pallas=frozenset(DW), reorg_order="darknet", dtype=torch.bfloat16,
                         channels=3, height=height, width=height)
    c = None if height == 8 else 16
    assert [(s.layer.name, s.arg) for s in steps if s.op == "conv"] == \
        [("a", 128), ("b", None), ("c", c), ("dw", None), ("e", None), ("f", 8)]
    assert [engine.padded_width(op[1]) for op in plan if op[0] == "conv"] == \
        [128, None, 16, None, None, 8]
    # the walk: each padded conv's raw output is the first out_ch channels of the padded one
    rng = np.random.default_rng(height)
    folded = {d.name: {"w": torch.from_numpy(rng.standard_normal(
                  (d.out_ch, d.in_ch // d.groups, d.ksize, d.ksize)).astype(np.float32) * 0.3),
                       "b": torch.from_numpy(rng.normal(0, 0.5, d.out_ch).astype(np.float32))}
              for d in engine.plan_convs(plan)}
    engine.add_kernel_weights(plan, folded, frozenset(DW))
    assert sorted(k for k, lp in folded.items() if "w_pad" in lp) == ["a", "c", "f"]
    assert torch.equal(folded["a"]["w_pad"][125:], torch.zeros(3, 3, 3, 3))
    assert torch.equal(folded["a"]["w_pad"][:125], folded["a"]["w"])
    x = torch.from_numpy(rng.uniform(0, 1, (2, height, height, 3)).astype(np.float32))
    got = engine.run_plan(plan, folded, x, compute_dtype=torch.float32, pallas=frozenset(DW))
    y = x.permute(0, 3, 1, 2)
    for op in plan:
        if op[0] == "conv":
            d = op[1]
            y = bias_leaky(conv(y, folded[d.name]["w"], groups=d.groups), folded[d.name]["b"],
                           d.act)
        else:
            y = max_pool(y, op[1], op[2])
    assert got.shape == (2, (height - 2) // 2 + 1, (height - 2) // 2 + 1, 3)
    torch.testing.assert_close(got, y.permute(0, 2, 3, 1), rtol=0, atol=0)


@pytest.mark.parametrize("name", TABLE)
def test_no_conv_whose_width_is_a_multiple_of_8_is_padded(name):
    steps = _route(name)
    convs = [s for s in steps if s.op == "conv"]
    assert all(s.layer.out_ch % 8 and s.arg == -(-s.layer.out_ch // 8) * 8 for s in convs if s.arg)
    assert not [s.layer.name for s in convs if s.arg and s.layer.out_ch % 8 == 0]
    assert sum(bool(s.arg) for s in convs) == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backbone", ["darknet", "yolo9000"])
def test_the_padded_walk_equals_the_unpadded_walk(monkeypatch, backbone, dtype):
    """Full width at 64², seeded weights: the walk with the head at its
    padded width against the walk with every conv at its own width (no
    ``padded_width``), on the same folded weights."""
    model = flagship(backbone=backbone, dtype=getattr(torch, dtype))
    params, state = model.init(torch.Generator().manual_seed(1))
    folded = model.fold(params, state)
    assert [k for k, lp in folded.items() if "w_pad" in lp] == ["out"]
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = model.apply_folded(folded, x)
        monkeypatch.setattr(engine, "padded_width", lambda d: None)
        want = model.apply_folded(folded, x)
    assert got.shape == want.shape == (2, 2, 2, model.out_channels) and got.is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
