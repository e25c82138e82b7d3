"""Port parity, the export tools: ``ops/decode.py::decode_flat``,
``cli/export.py`` (``torch.export`` of the folded forward + decode, with the
forward kernels as the custom ops of ``kernels/ops.py``) and
``tools/onnx_export.py``, against ``yolojax`` on the CPU in f32 at 64² with
the same weights (``checkpoint.from_jax``).

Tolerances: ``decode_flat`` atol 1e-5 (elementwise f32 on equal inputs); a
replayed ``.pt2`` bit-identical to the port's eager forward + decode on the
same batch (the same aten ops and the same kernel wrappers run), and
within rtol/atol 1e-3 of the JAX forward + ``decode_flat``, the f32 bound
``tests/test_torch_models.py`` holds the raw head to (23 convolutions summed
in another order); the ONNX graph (ModelProto field 7) byte for byte the
reference exporter's for the same f32 weights, and the blob run through
``tests/test_onnx_export.py::run_onnx`` within that file's rtol 2e-4 / atol
2e-5 of the port's eager output.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from test_onnx_export import parse_model, pb_decode, run_onnx
from torch_port_families import ROOT, both, family_config, narrow_config
from yolojax.ops.decode import decode_flat as jdecode_flat
from yolojax.tools import onnx_export as jonnx
from yolojax_torch.cli import export as texport
from yolojax_torch.kernels import dwconv, dwsep, epilogue, ops, pool, reorg
from yolojax_torch.ops.decode import decode_flat
from yolojax_torch.tools import onnx_export

# custom-op calls each path's export holds at 64² (every routed depthwise
# layer of MobileNet takes dwsep at this size; with dwconv alone, dwconv; every
# conv → 2×2/2 pair takes maxpool2x2 with the conv's epilogue, at any width;
# every other conv hands its epilogue to bias_leaky_nhwc)
OPS_AT_64 = {"darknet": {"maxpool2x2": 5, "bias_leaky_nhwc": 18},
             "darknet-s2d": {"maxpool2x2": 5, "reorg_s2d": 1, "bias_leaky_nhwc": 17},
             "tiny": {"maxpool2x2": 5, "bias_leaky_nhwc": 4},
             "mobilenet": {"dwsep": 11, "bias_leaky_nhwc": 10}}


@pytest.mark.parametrize("b,h,w,a,c", [(2, 2, 2, 5, 20), (1, 4, 3, 2, 3), (3, 13, 13, 5, 80)])
def test_decode_flat_matches_jax(rng, b, h, w, a, c):
    raw = rng.normal(0, 3, (b, h, w, a * (5 + c))).astype(np.float32)
    anchors = rng.uniform(0.5, 4, (a, 2)).astype(np.float32)
    want = np.asarray(jdecode_flat(jnp.asarray(raw), jnp.asarray(anchors)))
    got = decode_flat(torch.from_numpy(raw), anchors)
    assert got.shape == (b, h * w * a, 5 + c)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _eager(model, folded, x):
    with torch.no_grad():
        return decode_flat(model.apply_folded(folded, x), torch.as_tensor(model.anchors))


@pytest.mark.parametrize("family,mods", [("darknet", ()), ("darknet-s2d", ()), ("tiny", ()),
                                         ("mobilenet", ()),
                                         ("mobilenet", ("model/pallas=nms fusedpost dwconv",))],
                         ids=["darknet", "darknet-s2d", "tiny", "mobilenet", "mobilenet-dwconv"])
def test_pt2_replay_matches_eager_and_jax(rng, tmp_path, family, mods):
    # Darknet's routes (its conv → pool pairs and epilogues) read no width, so
    # it runs at narrow widths; the others at full width, where their layers
    # route as on the card
    config = (narrow_config if family == "darknet" else family_config)(family, *mods)
    jmodel, (jp, js), model, (p, s) = both(config, rng)
    folded = model.fold(p, s)
    program = texport.export_program(model, folded, model.anchors, 64, batch=2)
    want_ops = {"dwconv3x3": 11, "bias_leaky_nhwc": 21} if mods else OPS_AT_64[family]
    assert ops.op_counts(program.graph) == want_ops
    path = tmp_path / "inference_64.pt2"
    torch.export.save(program, path)
    replay = torch.export.load(path).module()

    images = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    x = torch.from_numpy(images)
    got = replay(x)
    assert torch.equal(got, _eager(model, folded, x))
    jfolded = jmodel.fold(jp, js)
    want = np.asarray(jdecode_flat(jmodel.apply_folded(jfolded, jnp.asarray(images)),
                                   jnp.asarray(jmodel.anchors)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


REPLAY = """
import sys, torch
import yolojax_torch.kernels.ops
x, want = torch.load(sys.argv[2])
got = torch.export.load(sys.argv[1]).module()(x)
print("same" if torch.equal(got, want) else "differs")
"""


def test_export_cli_pt2_replays_in_a_fresh_process(rng, tmp_path):
    config_args = ["-c", str(ROOT / "config.ini"), str(ROOT / "config" / "tiny.ini"), "-m",
                   "model/pallas=nms fusedpost pool", "model/dtype=float32",
                   f"config/root={tmp_path}"]
    out = tmp_path / "tiny.pt2"
    assert texport.main(config_args + ["--device", "cpu", "--size", "64", "--batch", "2",
                                       "-o", str(out)]) == 0
    _, _, model, _ = both(family_config("tiny"), rng)
    params, state = model.init(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32))
    torch.save((x, _eager(model, model.fold(params, state), x)), tmp_path / "io.pt")
    proc = subprocess.run([sys.executable, "-c", REPLAY, str(out), str(tmp_path / "io.pt")],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "same"


def _fake_shapes(fn, *args):
    with FakeTensorMode() as mode:
        fakes = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        out = fn(*fakes)
    return [tuple(t.shape) for t in (out if isinstance(out, tuple) else (out,))]


def _op_cases(rng):
    f = lambda *shape: torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
    return [
        ("dwconv3x3", dwconv.dwconv3x3, (f(2, 9, 7, 16), f(3, 3, 16), f(16), 2, True)),
        ("dwconv3x3", dwconv.dwconv3x3, (f(1, 6, 6, 8), f(3, 3, 8), f(8), 1, False)),
        ("dwsep", dwsep.dwsep, (f(2, 9, 7, 16), f(3, 3, 16), f(16), f(16, 24), f(24), 2)),
        ("maxpool2x2", pool.maxpool2x2, (f(2, 6, 4, 8),)),
        ("maxpool2x2", pool.maxpool2x2, (f(2, 6, 4, 8), f(8), True, True)),
        ("maxpool2x2", pool.maxpool2x2, (f(2, 6, 4, 8), f(8), False, False)),
        ("reorg_s2d", reorg.reorg_s2d, (f(2, 6, 4, 8), 2)),
        ("reorg_s2d", reorg.reorg_s2d, (f(2, 6, 4, 8), 2, f(2, 3, 2, 5), f(8), True)),
        ("bias_leaky_nhwc", epilogue.bias_leaky_nhwc, (f(2, 6, 4, 8), f(8), True)),
        ("bias_leaky_nhwc", epilogue.bias_leaky_nhwc, (f(1, 3, 5, 125), f(125), False)),
        # a padded conv's raw output: the first 125 of 128 channels
        ("bias_leaky_nhwc", epilogue.bias_leaky_nhwc, (f(2, 3, 5, 128)[..., :125], f(125), True)),
    ]


@pytest.mark.parametrize("case", range(11))
def test_custom_op_equals_its_wrapper_and_fakes_its_shapes(rng, case):
    name, wrapper, args = _op_cases(rng)[case]
    op = getattr(ops, name)
    got, want = op(*args), wrapper(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g, w)
    assert _fake_shapes(op, *args) == [tuple(w.shape) for w in want]
    schema_args = list(args)
    if name == "dwsep":
        schema_args.append(None)
    torch.library.opcheck(getattr(torch.ops.yolojax_torch, name).default,
                          tuple(_schema_args(name, schema_args)))


def _schema_args(name, args):
    """The wrapper's positional arguments completed with its defaults, in
    the op schema's order."""
    defaults = {"dwconv3x3": (1, True), "dwsep": (1, None), "maxpool2x2": (None, True, False),
                "reorg_s2d": (2, None, None, True), "bias_leaky_nhwc": (True,)}[name]
    n_tensors = {"dwconv3x3": 3, "dwsep": 5, "maxpool2x2": 1, "reorg_s2d": 1,
                 "bias_leaky_nhwc": 2}[name]
    return list(args) + list(defaults[len(args) - n_tensors:])


@pytest.mark.parametrize("family", ["darknet", "darknet-s2d", "tiny", "mobilenet"])
def test_onnx_graph_bytes_equal_the_reference(rng, family):
    jmodel, (jp, js), model, _ = both(narrow_config(family), rng)
    jfolded = {k: {n: np.asarray(v) for n, v in lp.items()}
               for k, lp in jmodel.fold(jp, js).items()}
    folded = {k: {"w": torch.from_numpy(lp["w"].transpose(3, 2, 0, 1).copy()),
                  "b": torch.from_numpy(lp["b"])} for k, lp in jfolded.items()}
    blob = onnx_export.export_onnx(model, folded, model.anchors, 64, batch=2)
    ref = jonnx.export_onnx(jmodel, jfolded, jmodel.anchors, 64, batch=2)
    assert pb_decode(blob)[7] == pb_decode(ref)[7]
    assert onnx_export.check_model(blob) == jonnx.check_model(ref)


@pytest.mark.parametrize("family", ["darknet-s2d", "mobilenet"])
def test_onnx_blob_runs_to_the_eager_output(rng, family):
    _, _, model, (p, s) = both(narrow_config(family), rng)
    folded = model.fold(p, s)
    blob = onnx_export.export_onnx(model, folded, model.anchors, 64, batch=2)
    images = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    got = run_onnx(parse_model(blob), {"images": images})["detections"]
    want = _eager(model, folded, torch.from_numpy(images.transpose(0, 2, 3, 1).copy()))
    np.testing.assert_allclose(got, want.numpy(), rtol=2e-4, atol=2e-5)


def test_export_cli_onnx(tmp_path):
    out = tmp_path / "tiny.onnx"
    args = ["-c", str(ROOT / "config.ini"), str(ROOT / "config" / "tiny.ini"), "-m",
            "model/dtype=float32", f"config/root={tmp_path}"]
    assert texport.main(args + ["--device", "cpu", "--size", "64", "--format", "onnx",
                                "-o", str(out)]) == 0
    summary = onnx_export.check_model(out.read_bytes())
    assert summary["inputs"] == ["images"] and summary["outputs"] == ["detections"]
