"""Port parity, the Darknet-s2d detect slice and its three kernels: batched
greedy NMS over decoded boxes (``kernels/nms.py``), the 2×2/2 max pool
(``kernels/pool.py``) and the s2d reorg (``kernels/reorg.py``).

On the CPU each wrapper runs its plain version; it is held against the JAX
package's Pallas kernel run in interpret mode, as tests/test_kernels.py runs
it.  Tolerances: exact for all three (NMS picks, indices and scores are
compared and copied, never computed; a max and a layout shuffle are exact).
The slice runs full-width Darknet-19 with ``reorg = s2d`` and ``pallas = nms
pool reorg`` at 64² in f32, with the same seeded weights carried over by
``checkpoint.from_jax``: raw heads rtol/atol 1e-3 (test_torch_mobilenet.py's
bound: 23 convolutions summed in other orders), and the postprocess fed one
raw head: ``keep`` identical, conf and corners atol 1e-5.  The CUDA kernels
are compared with their plain versions on the card in
``tests/test_torch_cuda_nms_pool_reorg.py``; the fused pool and reorg modes
against JAX in ``tests/test_torch_fused_pool_reorg.py``.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import yolojax.kernels.pool as jpool
import yolojax.kernels.reorg as jreorg
import yolojax.models as jmodels
from yolojax.kernels.nms import nms_select_pallas, postprocess_pallas
from yolojax.models.darknet import Darknet as JDarknet
from yolojax.models.inference import Inference as JInference
from yolojax.ops.reorg import reorg as jreorg_op
from yolojax.ops.decode import Detections as JDetections
from yolojax.ops.decode import decode as jdecode
from yolojax_torch.kernels import _build
from yolojax_torch.kernels import nms as nk
from yolojax_torch.kernels import pool as pk
from yolojax_torch.kernels import reorg as rk
from yolojax_torch.models.blocks import max_pool
from yolojax_torch.models.darknet import Darknet
from yolojax_torch.models.engine import run_plan
from yolojax_torch.models.inference import Inference
from yolojax_torch.ops import reorg as ops_reorg
from yolojax_torch.ops.decode import Detections, decode
from yolojax_torch.utils.checkpoint import from_jax

TOKENS = frozenset({"nms", "pool", "reorg"})
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _boxes(rng, shape):
    center = rng.uniform(0.2, 0.8, (*shape, 2)).astype(np.float32)
    half = rng.uniform(0.05, 0.2, (*shape, 2)).astype(np.float32)
    return center - half, center + half


def _same_picks(got, want, atol):
    """got: PostProcessed of tensors, want: of numpy-able arrays; kept slots."""
    keep = np.asarray(want.keep)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(np.where(keep, got.conf.numpy(), 0),
                               np.where(keep, np.asarray(want.conf), 0), rtol=0, atol=atol)
    for name in ("yx_min", "yx_max"):
        np.testing.assert_allclose(np.where(keep[..., None], getattr(got, name).numpy(), 0),
                                   np.where(keep[..., None], np.asarray(getattr(want, name)), 0),
                                   rtol=0, atol=atol, err_msg=name)


# -- the kernels' plain versions against the Pallas kernels -----------------

@pytest.mark.parametrize("lead,box_lead,n,max_out", [
    ((), (), 64, 16),              # one row, tests/test_kernels.py:39
    ((2, 3), (2, 1), 40, 8),       # (image, class) rows, boxes broadcast over classes
    ((2, 3), (2, 3), 40, 8),       # one box row per score row
])
def test_nms_select_plain_matches_pallas_kernel(rng, lead, box_lead, n, max_out):
    yx_min, yx_max = _boxes(rng, (*box_lead, n))
    scores = rng.uniform(0, 1, (*lead, n)).astype(np.float32)
    bcast = lambda v: jnp.broadcast_to(jnp.asarray(v), (*lead, n, 2))
    with pltpu.force_tpu_interpret_mode():
        want = nms_select_pallas(bcast(yx_min), bcast(yx_max), jnp.asarray(scores), 0.3, 0.45,
                                 max_out)
    got = nk.nms_select(torch.from_numpy(yx_min), torch.from_numpy(yx_max),
                        torch.from_numpy(scores), 0.3, 0.45, max_out)
    assert np.asarray(want[2]).any()
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    for g, w, name in zip(got, want, ("idx", "conf", "valid")):
        assert g.shape == (*lead, max_out)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_postprocess_nms_plain_matches_pallas(rng):
    b, n, c, topk = 2, 45, 5, 10
    yx_min, yx_max = _boxes(rng, (b, n))
    conf = rng.uniform(0, 1, (b, n, c)).astype(np.float32) ** 3
    iou = rng.uniform(0, 1, (b, n)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = postprocess_pallas(JDetections(*(jnp.asarray(a) for a in
                                                (yx_min, yx_max, iou, conf, conf))),
                                  0.05, 0.45, topk)
    det = Detections(*(torch.from_numpy(a) for a in (yx_min, yx_max, iou, conf, conf)))
    got = nk.postprocess_nms(det, 0.05, 0.45, topk)
    assert np.asarray(want.keep).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("shape", [(1, 16, 16, 128), (2, 8, 8, 256), (2, 2, 2, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_maxpool_plain_matches_pallas_kernel(rng, shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x = rng.standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpool.maxpool2x2_pallas(jnp.asarray(x, jdt)), np.float32)
    got = pk.maxpool2x2(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.is_contiguous()
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (1, 6, 4, 3), (2, 4, 4, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reorg_plain_matches_pallas_kernel(rng, shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x = rng.standard_normal(shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jreorg.reorg_pallas(jnp.asarray(x, jdt), 2), np.float32)
    got = rk.reorg_s2d(torch.from_numpy(x).to(tdt), 2)
    assert got.dtype == tdt
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, 4 * shape[3])
    np.testing.assert_array_equal(got.float().numpy(), want)


# -- the Darknet-s2d slice --------------------------------------------------

@pytest.fixture(scope="module")
def jax_darknet():
    """Full-width JAX Darknet-19 (4 classes) with randomized BN statistics."""
    rng = np.random.default_rng(11)
    anchors = rng.uniform(0.5, 3.0, (5, 2)).astype(np.float32)
    model = JDarknet(anchors=anchors, num_classes=4, dtype=jnp.float32, reorg_order="s2d",
                     pallas=TOKENS)
    params, state = model.init(jax.random.PRNGKey(5))
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    for name in state:
        shape = state[name]["mean"].shape
        state[name]["mean"] = rng.normal(0, 0.2, shape).astype(np.float32)
        state[name]["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        params[name]["gamma"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        params[name]["beta"] = rng.normal(0, 0.1, shape).astype(np.float32)
    return model, params, state


def _spy(monkeypatch, module, name, log, kind):
    """Wrap ``module.name`` to log (kind, input shape) per call."""
    fn = getattr(module, name)

    def spy(x, *args):
        log.append((kind, tuple(x.shape)))
        return fn(x, *args)

    monkeypatch.setattr(module, name, spy)


def _port(jmodel):
    return Darknet(anchors=jmodel.anchors, num_classes=jmodel.num_classes, dtype=torch.float32,
                   pallas=jmodel.pallas, reorg_order=jmodel.reorg_order)


def test_routing_and_raw_head_at_64_match_the_jax_engine(rng, monkeypatch, jax_darknet):
    jmodel, params, state = jax_darknet
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jlog = []
    monkeypatch.setattr(jmodels, "pallas_active", lambda which, enabled: which in enabled)
    _spy(monkeypatch, jpool, "maxpool2x2_pallas", jlog, "pool")
    _spy(monkeypatch, jreorg, "reorg_pallas", jlog, "reorg")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))

    log = []
    _spy(monkeypatch, pk, "maxpool2x2", log, "pool")
    _spy(monkeypatch, rk, "reorg_s2d", log, "reorg")
    model = _port(jmodel)
    with torch.no_grad():
        got = model.apply_folded(model.fold(*from_jax(params, state)), torch.from_numpy(x))
    # the JAX engine routes pool3-pool5 (C 128, 256, 512) and leaves pool1-pool2
    # (C 32, 64) to XLA; the port's conv → pool pairs all take the pool kernel
    assert jlog == [("pool", (2, 16, 16, 128)), ("pool", (2, 8, 8, 256)),
                    ("pool", (2, 4, 4, 512)), ("reorg", (2, 4, 4, 64))]
    assert log == [("pool", (2, 64, 64, 32)), ("pool", (2, 32, 32, 64))] + jlog
    assert got.shape == want.shape == (2, 2, 2, 45)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_postprocess_of_one_raw_head_matches_jax(rng, jax_darknet):
    """detect_fn's nms path fed the JAX forward's raw head on both sides."""
    jmodel, params, state = jax_darknet
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    raw = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))
    with pltpu.force_tpu_interpret_mode():
        want = postprocess_pallas(jdecode(jnp.asarray(raw), jnp.asarray(jmodel.anchors)),
                                  0.005, 0.45, 100)
    got = nk.postprocess_nms(decode(torch.tensor(raw), jmodel.anchors), 0.005, 0.45, 100)
    assert np.asarray(want.keep).any()
    _same_picks(got, want, 1e-5)


def test_detect_fn_matches_jax(rng, monkeypatch, jax_darknet):
    jmodel, params, state = jax_darknet
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    monkeypatch.setattr(jmodels, "pallas_active", lambda which, enabled: which in enabled)
    jinf = JInference(jmodel)
    with pltpu.force_tpu_interpret_mode():
        want = jinf.detect_fn(0.005, 0.45, 100)(jinf.fold(params, state), jnp.asarray(x))

    calls = []
    _spy(monkeypatch, nk, "nms_select", calls, "nms")
    inference = Inference(_port(jmodel))
    got = inference.detect_fn(0.005, 0.45, 100)(inference.fold(*from_jax(params, state)),
                                                torch.from_numpy(x))
    assert calls == [("nms", (2, 1, 20, 2))]          # boxes broadcast over the 4 classes
    assert np.asarray(want.keep).any()
    _same_picks(got, want, 1e-4)


@pytest.mark.parametrize("order", ["darknet", "s2d"])
def test_reorg_token_takes_the_kernel_only_in_s2d_order(rng, monkeypatch, order):
    x = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    calls = []
    _spy(monkeypatch, rk, "reorg_s2d", calls, "reorg")
    got = run_plan([("reorg", 2)], {}, torch.from_numpy(x), compute_dtype=torch.float32,
                   reorg_order=order, pallas=frozenset({"reorg"}))
    assert calls == ([("reorg", (2, 4, 6, 8))] if order == "s2d" else [])
    want = ops_reorg.reorg(torch.from_numpy(x), 2, order)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jreorg_op(x, 2, order)))


def test_pool_gate_reads_the_nchw_shape(rng, monkeypatch):
    """H and W from x.shape[2:], at any C and under any tokens; only 2×2/2
    pools over an even H and W take the kernel, the rest ``max_pool``."""
    calls = []
    _spy(monkeypatch, pk, "maxpool2x2", calls, "pool")
    for shape, plan, routed in [((1, 4, 6, 128), [("pool", 2, 2)], True),
                                ((1, 4, 5, 128), [("pool", 2, 2)], False),   # odd W
                                ((1, 128, 128, 64), [("pool", 2, 2)], True),  # C 64
                                ((1, 4, 6, 5), [("pool", 2, 2)], True),     # C 5, W 6
                                ((1, 4, 4, 128), [("pool", 2, 1)], False)]:
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        want = max_pool(x.permute(0, 3, 1, 2), *plan[0][1:]).permute(0, 2, 3, 1)
        for pallas in (frozenset({"pool"}), frozenset()):
            calls.clear()
            got = run_plan(plan, {}, x, compute_dtype=torch.float32, pallas=pallas)
            assert calls == ([("pool", shape)] if routed else []), shape
            torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the wrappers' contracts -------------------------------------------------

def test_cpu_tensors_take_plain_versions_without_launch(rng):
    before = nk.nms_select.launches, pk.maxpool2x2.launches, rk.reorg_s2d.launches
    x = torch.from_numpy(rng.standard_normal((2, 4, 4, 8)).astype(np.float32))
    torch.testing.assert_close(pk.maxpool2x2(x), pk.maxpool2x2_plain(x), rtol=0, atol=0)
    torch.testing.assert_close(rk.reorg_s2d(x, 2), ops_reorg.reorg_s2d(x, 2), rtol=0, atol=0)
    yx_min, yx_max = (torch.from_numpy(a) for a in _boxes(rng, (2, 1, 10)))
    nk.nms_select(yx_min, yx_max, torch.rand(2, 3, 10), 0.1, 0.45, 4)
    assert (nk.nms_select.launches, pk.maxpool2x2.launches, rk.reorg_s2d.launches) == before


def test_unsupported_device_raises():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pk.maxpool2x2(x)
    with pytest.raises(ValueError, match="unsupported device"):
        rk.reorg_s2d(x, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        nk.nms_select(torch.empty((1, 1, 5, 2), device="meta"),
                      torch.empty((1, 1, 5, 2), device="meta"),
                      torch.empty((1, 3, 5), device="meta"), 0.1, 0.45, 4)


@pytest.mark.parametrize("case", ["dtype", "odd", "layout"])
def test_wrapper_checks_reject_what_the_kernels_do_not_take(case):
    x, error = torch.zeros((2, 4, 6, 8)), ValueError
    if case == "dtype":
        x, error = x.half(), TypeError
    elif case == "odd":
        x = torch.zeros((2, 4, 5, 8))
    else:
        x = x.permute(0, 2, 1, 3)
    with pytest.raises(error):
        pk._check(x)
    with pytest.raises(error):
        rk._check(x, 2)


def test_reorg_raises_on_sizes_not_divisible_by_the_stride():
    with pytest.raises(ValueError, match="not divisible"):
        rk.reorg_s2d(torch.zeros((1, 6, 6, 4)), 4)


@pytest.mark.parametrize("module", [nk, pk, rk])
def test_failed_build_raises(tmp_path, monkeypatch, module):
    """A compiler failure is an error, never a silent fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        module.build()
    assert not list(tmp_path.glob("*.so"))


def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """An edited header beside a source builds a new library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("nms_select.cu", "greedy_nms.cuh"):
        shutil.copy(_build.CSRC / name, csrc / name)
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi; shift\ndone\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    source = csrc / "nms_select.cu"
    first = _build.build(source)
    assert _build.build(source) == first
    header = csrc / "greedy_nms.cuh"
    header.write_text(header.read_text() + "// edited\n")
    second = _build.build(source)
    assert second != first and first.exists() and second.exists()
    assert second == _build.library_path(source)
