"""The deploy paths on the card: the five forward kernels' custom ops
(``kernels/ops.py``) in eager mode and through ``torch.export``, exported
forwards replayed, and the host detect path (``detect_fn_host``: forward on
the card, native NMS on the host) against ``detect_fn`` (the fused kernel).

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU interpret mode.  The file imports torch, numpy, pytest and
``yolojax_torch`` only, so it runs on a machine without JAX (the command is
in ``tests/test_torch_cuda_kernels.py``).

An op launches the same kernel as its wrapper, so op and wrapper agree bit
for bit, eager and replayed.  Against the plain versions the bounds are
those of ``tests/test_torch_cuda_kernels.py`` and
``tests/test_torch_cuda_nms_pool_reorg.py``: pool and reorg exact,
dwconv3x3 exact against its tap-order reference, dwsep f32 rtol/atol 1e-4
and bf16 1e-2 (the plain pair sums in cuDNN's order).  The host path and
the fused kernel decode the same raw head bit for bit (``ops/decode.py``),
so ``keep``, the pick order, conf and corners must be identical.
"""

import numpy as np
import pytest
import torch

from yolojax_torch.cli.export import export_program
from yolojax_torch.kernels import dwconv, dwsep, epilogue, ops, pool, reorg
from yolojax_torch.models.darknet import Darknet, Tiny
from yolojax_torch.models.inference import Inference
from yolojax_torch.models.mobilenet import MobileNet
from yolojax_torch.ops.decode import decode_flat

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ANCHORS = np.asarray([[1.2, 0.9], [3.1, 2.4], [5.0, 6.5]], np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)


def _t(rng, shape, dtype, scale=1.0):
    return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to("cuda", dtype)


def _cases(rng, dtype):
    """(name, wrapper, plain, arguments, exact) at routed shapes of the paths."""
    f32 = torch.float32
    x_dw, taps = _t(rng, (4, 26, 26, 128), dtype), _t(rng, (3, 3, 128), dtype, 0.3)
    x_sep = _t(rng, (4, 13, 13, 512), dtype)
    conv = _t(rng, (4, 26, 26, 512), dtype)
    return [
        ("dwconv3x3", dwconv.dwconv3x3, dwconv.dwconv3x3_taps,
         (x_dw, taps, _t(rng, (128,), f32), 2, True), True),
        ("dwsep", dwsep.dwsep, dwsep.dwsep_plain,
         (x_sep, _t(rng, (3, 3, 512), dtype, 0.3), _t(rng, (512,), f32),
          _t(rng, (512, 1024), dtype, 0.05), _t(rng, (1024,), f32), 1), False),
        ("maxpool2x2", pool.maxpool2x2, pool.maxpool2x2_plain,
         (conv, _t(rng, (512,), f32), True, True), True),
        ("maxpool2x2", pool.maxpool2x2, pool.maxpool2x2_plain, (conv,), True),
        ("reorg_s2d", reorg.reorg_s2d, reorg.reorg_s2d_plain,
         (_t(rng, (4, 26, 26, 64), dtype), 2, _t(rng, (4, 13, 13, 1024), dtype),
          _t(rng, (64,), f32), True), True),
        ("bias_leaky_nhwc", epilogue.bias_leaky_nhwc, epilogue.bias_leaky_nhwc_plain,
         (conv, _t(rng, (512,), f32), True), True),
    ]


class _One(torch.nn.Module):
    """One op call over the module's inputs, for torch.export."""

    def __init__(self, fn, *static):
        super().__init__()
        self.fn, self.static = fn, static

    def forward(self, *tensors):
        return self.fn(*tensors, *self.static)


def _split(args):
    n = next((i for i, a in enumerate(args) if not isinstance(a, torch.Tensor)), len(args))
    return args[:n], args[n:]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_custom_ops_eager_and_exported_on_the_card(cuda_device, rng, dtype):
    """Each op against its wrapper and plain version, then exported alone
    and replayed: one op node, one launch, the eager op's bits.  The
    arguments after the first non-tensor (reorg's tail and bias) are
    constants of the exported module."""
    for name, wrapper, plain, args, exact in _cases(rng, DTYPES[dtype]):
        op = getattr(ops, name)
        got = _as_tuple(op(*args))
        direct = _as_tuple(wrapper(*args))
        want = _as_tuple(plain(*args))
        for g, d, w in zip(got, direct, want):
            assert torch.equal(_bits(g), _bits(d)), name
            if exact:
                assert torch.equal(_bits(g), _bits(w)), name
            else:
                tol = 1e-4 if dtype == "float32" else 1e-2
                torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
        tensors, static = _split(args)
        program = torch.export.export(_One(op, *static), tuple(tensors))
        assert ops.op_counts(program.graph) == {name: 1}
        before = wrapper.launches
        replayed = _as_tuple(program.module()(*tensors))
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, name
        for g, r in zip(got, replayed):
            assert torch.equal(_bits(g), _bits(r)), name


def _model(cls, pallas, dtype=torch.bfloat16, **kw):
    model = cls(anchors=ANCHORS, num_classes=20, dtype=dtype, pallas=frozenset(pallas), **kw)
    params, state = model.init(torch.Generator().manual_seed(0), "cuda")
    return model, model.fold(params, state)


# (model, pallas tokens, fields): each program calls the ops and replays the
# launches its route gives (``Inference.launches``)
PATHS = {"darknet": (Darknet, {"nms", "fusedpost"}, {}),
         "tiny": (Tiny, {"nms", "fusedpost", "pool"}, {}),
         "darknet-s2d": (Darknet, {"nms", "pool", "reorg"}, {"reorg_order": "s2d"}),
         "mobilenet": (MobileNet, {"nms", "fusedpost", "dwsep", "dwconv"}, {})}
COUNTERS = {"dwconv3x3": dwconv.dwconv3x3, "dwsep": dwsep.dwsep,
            "maxpool2x2": pool.maxpool2x2, "reorg_s2d": reorg.reorg_s2d,
            "bias_leaky_nhwc": epilogue.bias_leaky_nhwc}


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_exported_forward_replays_its_kernels_bit_identically(cuda_device, rng, tmp_path, path):
    cls, pallas, kw = PATHS[path]
    model, folded = _model(cls, pallas, **kw)
    want_ops = Inference(model).launches(416, post=False)
    program = export_program(model, folded, model.anchors, 416, batch=2)
    assert ops.op_counts(program.graph) == want_ops
    torch.export.save(program, tmp_path / "p.pt2")
    replay = torch.export.load(tmp_path / "p.pt2").module()
    x = torch.from_numpy(rng.uniform(0, 1, (2, 416, 416, 3)).astype(np.float32)).cuda()
    with torch.no_grad():
        want = decode_flat(model.apply_folded(folded, x), torch.as_tensor(ANCHORS, device="cuda"))
    for fn in COUNTERS.values():
        fn.launches = 0
    got = replay(x)
    torch.cuda.synchronize()
    assert {k: fn.launches for k, fn in COUNTERS.items() if fn.launches} == want_ops
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [0.005, 0.3])
@pytest.mark.parametrize("objectness", [-6.0, 0.0])
def test_detect_fn_host_equals_the_fused_kernel_on_the_card(cuda_device, rng, threshold,
                                                            objectness):
    from yolojax_torch.native import native_nms_available

    assert native_nms_available(), "the native NMS library did not build"
    model, folded = _model(Tiny, {"nms", "fusedpost", "pool"})
    folded["out"]["b"].view(-1, 25)[:, 4] = objectness
    inf = Inference(model)
    x = torch.from_numpy(rng.uniform(0, 1, (4, 416, 416, 3)).astype(np.float32)).cuda()
    want = inf.detect_fn(threshold, 0.45, 100)(folded, x)
    got = inf.detect_fn_host(threshold, 0.45, 100)(folded, x)
    keep = want.keep.cpu()
    assert torch.equal(got.keep, keep)
    for g, w in zip((got.conf, got.yx_min, got.yx_max), (want.conf, want.yx_min, want.yx_max)):
        k = keep if g.dim() == 3 else keep[..., None].expand_as(g)
        assert torch.equal(_bits(g[k]), _bits(w.cpu()[k]))
