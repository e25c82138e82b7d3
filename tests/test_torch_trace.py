"""The port's tracer (``yolojax_torch/utils/trace.py``) and its span sites
in the detect call (``models/inference.py``), the folded plan walk
(``models/engine.py::run_plan``) and the train step
(``parallel/mesh.py::make_train_step``), on the CPU at 64².

With no profiler recording a site costs one flag read: the tests replace
``torch.profiler.record_function`` and ``torch.cuda.Event`` with functions
that fail, and the tracer keeps nothing.  Under ``torch.profiler.profile``
each executed op of the folded walk is one leaf span under the call's
``yolojax_torch.forward``, every span of a call shares the root's id, and the
profiler's own events carry the same names.  Outputs are bit-identical with
spans on and off, and ``torch.export`` under an active profiler holds no
profiler op.
"""

import itertools
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolojax_torch.cli import export as texport
from yolojax_torch.cli.train import step_phases
from yolojax_torch.data.transform import TrainAugment
from yolojax_torch.entry import flagship
from yolojax_torch.models.engine import plan_convs
from yolojax_torch.models.inference import Inference
from yolojax_torch.ops.loss import LossConfig
from yolojax_torch.parallel.mesh import make_train_step
from yolojax_torch.utils import trace
from yolojax_torch.utils.train import Optimizer

SIZE = 64
WEIGHTS = {"coord": 1.0, "object": 5.0, "noobject": 1.0, "cls": 1.0, "prior": 0.01}
# the folded walk's leaf spans a 64² call takes on each route, and the convs
# whose layer the kernels of the route take whole (no conv and epilogue span)
ROUTES = {
    "darknet": ("darknet", (), "darknet",
                {"layout": 2, "conv": 23, "epilogue": 18, "pool": 5, "reorg": 1, "concat": 1}),
    "darknet-s2d": ("darknet", ("pool", "reorg"), "s2d",
                    {"layout": 2, "conv": 23, "epilogue": 17, "pool": 5, "reorg": 1}),
    "mobilenet": ("mobilenet", ("dwconv", "dwsep"), "darknet",
                  {"layout": 2, "dwsep": 11, "conv": 10, "epilogue": 10, "reorg": 1,
                   "concat": 1}),
}


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def _model(route):
    backbone, kernels, order, _ = ROUTES[route]
    model = flagship(backbone=backbone, dtype=torch.float32)
    model.pallas = frozenset({"nms", "fusedpost", *kernels})
    model.reorg_order = order
    return model


def _detect(route, seed=0):
    model = _model(route)
    params, state = model.init(torch.Generator().manual_seed(seed))
    inference = Inference(model)
    folded = inference.fold(params, state)
    images = torch.rand((2, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(seed + 1))
    return model, inference.detect_fn(0.005, 0.45, 10), folded, images


def _profiled(fn, *args):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    return out, prof


def _forbid(monkeypatch):
    def fail(*args, **kwargs):
        raise AssertionError("a span recorded with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(torch.cuda, "Event", fail)


def _train_batch(b=2, canvas=None):
    rng = np.random.default_rng(0)
    center = rng.uniform(0.3, 0.7, (b, 4, 2)).astype(np.float32)
    half = rng.uniform(0.05, 0.2, (b, 4, 2)).astype(np.float32)
    batch = {"yx_min": np.clip(center - half, 0, 1), "yx_max": np.clip(center + half, 0, 1),
             "cls": rng.integers(0, 20, (b, 4)).astype(np.int64),
             "valid": np.ones((b, 4), bool)}
    if canvas is None:
        batch["images"] = rng.uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
    else:
        batch["canvas"] = rng.integers(0, 255, (b, canvas, canvas, 3), dtype=np.uint8)
        batch["hw"] = np.full((b, 2), SIZE, np.float32)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _train(augment=None, group=None):
    model = flagship(backbone="tiny", dtype=torch.float32)
    params, state = model.init(torch.Generator().manual_seed(0))
    optimizer = Optimizer("sgd", schedule=lambda count: 1e-3, clip=5.0, momentum=0.9)
    step = make_train_step(model, optimizer, WEIGHTS, LossConfig(), augment=augment,
                           group=group)
    return step, params, state, optimizer.init(params)


def _named(spans, name):
    return [s for s in spans if s["name"] == name]


@pytest.mark.parametrize("route", ["darknet", "mobilenet"])
def test_no_profiler_records_nothing_and_enters_no_record_function(monkeypatch, route):
    model, detect, folded, images = _detect(route)
    _forbid(monkeypatch)
    detect(folded, images)
    model.apply_folded(folded, images)
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["dropped"] == 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_profiled_detect_has_one_leaf_per_executed_op_under_one_root(route):
    model, detect, folded, images = _detect(route)
    _, prof = _profiled(detect, folded, images)
    spans = trace.snapshot()["spans"]
    (root,) = _named(spans, "yolojax_torch.detect")
    (forward,) = _named(spans, "yolojax_torch.forward")
    (post,) = _named(spans, "yolojax_torch.post")
    assert root["parent"] is None and root["attrs"] == {"images": 2}
    assert forward["parent"] == post["parent"] == root["id"]
    assert all(s["root"] == root["id"] for s in spans)
    plan = [s for s in spans if s["name"].startswith("yolojax_torch.plan.")]
    assert all(s["parent"] == forward["id"] for s in plan)
    assert len(spans) == len(plan) + 3
    leaves = Counter(s["name"].rsplit(".", 1)[1] for s in plan)
    assert leaves == ROUTES[route][3]
    # every conv that no kernel takes whole runs once, in plan order; the
    # dwsep kernel takes a depthwise conv and the 1x1 conv after it
    names = [d.name for d in plan_convs(model.plan)]
    whole = set()
    for s in plan:
        if s["name"].endswith((".dwsep", ".dwconv")):
            whole.add(s["attrs"]["layer"])
        if s["name"].endswith(".dwsep"):
            whole.add(names[names.index(s["attrs"]["layer"]) + 1])
    convs = [s["attrs"]["layer"] for s in _named(spans, "yolojax_torch.plan.conv")]
    assert convs == [n for n in names if n not in whole]
    # the head (125 channels) is the one conv run at a padded width
    padded = [s["attrs"] for s in _named(spans, "yolojax_torch.plan.conv")
              if "padded" in s["attrs"]]
    assert padded == [{"layer": "out", "padded": 128}]
    # spans end in order, each inside its parent
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["t0_ns"] <= s["t1_ns"] and s["host_ms"] >= 0 and s["device_ms"] is None
        if s["parent"] is not None:
            up = by_id[s["parent"]]
            assert up["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= up["t1_ns"]


@pytest.mark.parametrize("route", ["darknet", "darknet-s2d"])
def test_profiler_events_carry_the_span_names(route):
    _, detect, folded, images = _detect(route)
    _, prof = _profiled(detect, folded, images)
    spans = Counter(s["name"] for s in trace.snapshot()["spans"])
    events = Counter(e.name for e in prof.events() if e.name.startswith("yolojax_torch."))
    assert events == spans


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_detect_outputs_are_bit_identical_with_spans_on_and_off(route):
    _, detect, folded, images = _detect(route)
    off = detect(folded, images)
    on, _ = _profiled(detect, folded, images)
    assert trace.snapshot()["spans"]
    for a, b in zip(off, on, strict=True):
        assert torch.equal(a, b)


def test_host_detect_has_the_same_three_spans():
    model = _model("darknet")
    params, state = model.init(torch.Generator().manual_seed(0))
    inference = Inference(model)
    folded = inference.fold(params, state)
    images = torch.rand((2, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(1))
    run = inference.detect_fn_host(0.005, 0.45, 10)
    off = run(folded, images)
    on, _ = _profiled(run, folded, images)
    spans = trace.snapshot()["spans"]
    top = [s["name"] for s in spans if not s["name"].startswith("yolojax_torch.plan.")]
    assert top == ["yolojax_torch.forward", "yolojax_torch.post", "yolojax_torch.detect"]
    for a, b in zip(off, on, strict=True):
        assert torch.equal(a, b)


def test_train_step_is_bit_identical_with_spans_on_and_off():
    batch = _train_batch()
    step, params, state, opt = _train()
    off = step(params, state, opt, batch, 0)
    step, params, state, opt = _train()
    on, _ = _profiled(step, params, state, opt, batch, 0)
    assert trace.snapshot()["spans"]
    flat = lambda tree: [v for lp in tree.values() for v in lp.values()]
    for a, b in zip(off[:2], on[:2]):
        for u, v in zip(flat(a), flat(b), strict=True):
            assert torch.equal(u, v)
    for k in ("total", "grad_norm"):
        assert torch.equal(off[3][k], on[3][k])


@pytest.mark.parametrize("with_augment", [False, True])
def test_profiled_train_step_has_its_phases(with_augment):
    augment = TrainAugment() if with_augment else None
    step, params, state, opt = _train(augment)
    if augment is None:
        args = (_train_batch(), 0)
    else:
        args = (_train_batch(canvas=96), 0, augment.draw(torch.Generator().manual_seed(1), 2),
                SIZE)
    _profiled(step, params, state, opt, *args)
    spans = trace.snapshot()["spans"]
    (root,) = _named(spans, "yolojax_torch.train_step")
    assert root["attrs"] == {"images": 2} and all(s["root"] == root["id"] for s in spans)
    children = [s["name"].rsplit(".", 1)[1] for s in spans if s["parent"] == root["id"]]
    want = ["forward", "loss", "backward", "optimizer"]
    assert children == (["augment"] + want if with_augment else want)
    assert list(step_phases(spans)) == children
    # the unfolded forward walks no plan span
    assert not [s for s in spans if ".plan." in s["name"]]


def test_train_step_in_a_group_has_an_allreduce_phase(tmp_path):
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    torch.distributed.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        group = torch.distributed.group.WORLD
        step, params, state, opt = _train(group=group)
        _profiled(step, params, state, opt, _train_batch(), 0)
    finally:
        torch.distributed.destroy_process_group()
    spans = trace.snapshot()["spans"]
    (root,) = _named(spans, "yolojax_torch.train_step")
    children = [s["name"].rsplit(".", 1)[1] for s in spans if s["parent"] == root["id"]]
    assert children == ["forward", "loss", "backward", "allreduce", "optimizer"]


@pytest.mark.parametrize("route", ["darknet-s2d", "mobilenet"])
def test_export_under_an_active_profiler_holds_no_profiler_op(route):
    model = _model(route)
    params, state = model.init(torch.Generator().manual_seed(0))
    folded = Inference(model).fold(params, state)
    targets = lambda program: [str(n.target) for n in program.graph.nodes]
    off = targets(texport.export_program(model, folded, model.anchors, SIZE))
    with profile(activities=[ProfilerActivity.CPU]):
        on = targets(texport.export_program(model, folded, model.anchors, SIZE))
    assert not [t for t in on if "profiler" in t or "record_function" in t]
    assert on == off and "aten.conv2d.default" in on
    assert trace.snapshot()["spans"] == []


def test_the_cap_counts_dropped_spans(monkeypatch):
    _, detect, folded, images = _detect("darknet")
    monkeypatch.setattr(trace, "MAX_SPANS", 5)
    _profiled(detect, folded, images)
    snap = trace.snapshot()
    # 50 leaves, forward, post and the root: the first five to end are kept
    assert len(snap["spans"]) == 5 and snap["dropped"] == 53 - 5
    assert all(s["name"].startswith("yolojax_torch.plan.") for s in snap["spans"])
    trace.reset()
    assert trace.snapshot()["dropped"] == 0


def test_spans_of_two_threads_keep_their_own_roots():
    def work(name):
        with trace.span(name):
            with trace.span(name + ".child"):
                pass

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = trace.snapshot()["spans"]
    roots = {s["name"]: s["id"] for s in spans if s["parent"] is None}
    assert sorted(roots) == [f"t{i}" for i in range(4)]
    for s in spans:
        if s["parent"] is not None:
            assert s["parent"] == s["root"] == roots[s["name"].split(".")[0]]


def test_snapshot_reads_the_launch_counters():
    from yolojax_torch.kernels.dwsep import dwsep
    from yolojax_torch.kernels.epilogue import bias_leaky_nhwc
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused

    from yolojax_torch.kernels.tree import tree_decode

    counters = trace.snapshot()["counters"]
    assert counters["dwsep"] == dwsep.launches
    assert counters["bias_leaky_nhwc"] == bias_leaky_nhwc.launches
    assert counters["postprocess_fused"] == postprocess_fused.launches
    assert counters["tree_decode"] == tree_decode.launches
    # the tree walk's counts on the card: zero where it never ran (the CPU)
    assert counters["tree_walks"] == counters["tree_groups_visited"] == 0
    assert set(counters) == {"dwconv3x3", "dwsep", "maxpool2x2", "reorg_s2d",
                             "bias_leaky_nhwc", "postprocess_fused", "nms_select",
                             "tree_decode", "tree_walks", "tree_groups_visited"}


def test_cuda_spans_time_on_the_roots_stream_and_resolve_in_the_snapshot(monkeypatch):
    """The event path, with fakes of ``torch.cuda``'s stream, event and
    synchronize: a CUDA root looks its stream up once, every span under it
    records both its events on that stream, and the snapshot resolves each
    pair after one synchronize."""
    lookups, syncs, clock = [], [], itertools.count()

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = self.stream = None

        def record(self, stream=None):
            self.stream, self.at = stream, next(clock)

        def elapsed_time(self, end):
            return float(end.at - self.at)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: lookups.append(1) or "s0")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: syncs.append(1))
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("root", cuda=True):
            with trace.span("a"):
                pass
            with trace.span("b"):
                with trace.span("c"):
                    pass
        with trace.span("host"):
            pass
    snap = trace.snapshot()
    assert len(lookups) == 1 and len(syncs) == 1
    device = {s["name"]: s["device_ms"] for s in snap["spans"]}
    # the events in record order: root0 a0 a1 b0 c0 c1 b1 root1
    assert device == {"a": 1.0, "c": 1.0, "b": 3.0, "root": 7.0, "host": None}
