"""The port's nms_select, maxpool2x2 and reorg_s2d kernels on the card,
against their plain versions, and the Darknet-s2d and Tiny forwards that
route through them.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU interpret mode.  The file imports torch, numpy, pytest and
``yolojax_torch`` only, so it runs on a machine without JAX (the command is
in ``tests/test_torch_cuda_kernels.py``).

All comparisons are exact, bit for bit: NMS compares and copies scores; the
pool picks one of its four inputs; the reorg and concat move bits; the fused
bias + leaky epilogue runs the plain version's f32 steps in the same order
(built with ``--fmad=false``) and rounds as torch's cast on the card does.
The inputs carry NaN, ±inf and signed zeros so that the pool's NaN rule and
the epilogue's signs are held too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from yolojax_torch.kernels import nms as nk
from yolojax_torch.kernels import pool as pk
from yolojax_torch.kernels import reorg as rk
from yolojax_torch.models.darknet import Darknet, Tiny
from yolojax_torch.ops import reorg as ops_reorg
from yolojax_torch.ops.nms import nms_select as nms_plain

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the routed pools' inputs at 416, batch 8: Darknet's pool3-pool5, Tiny's pool4-pool5
ROUTED_POOLS = [(8, 104, 104, 128), (8, 52, 52, 256), (8, 26, 26, 512), (8, 52, 52, 128),
                (8, 26, 26, 256)]
# chip_smoke.py's POOL_EXTRA, and C = 36 (not a whole bf16 unit of 8)
POOL_EXTRA = [(8, 26, 26, 72), (2, 2, 2, 128), (2, 2, 2, 72), (3, 6, 4, 3), (2, 6, 6, 36)]
# (x, tail channels): c21's output and Darknet's top at 416, batch 8; chip_smoke.py's
# REORG_EXTRA with tails; C = 36 and tails of 5 and 6 channels (no whole units)
REORG_CASES = [((8, 26, 26, 64), 1024), ((2, 26, 26, 3), 5), ((2, 26, 26, 72), 16),
               ((2, 2, 2, 64), 8), ((2, 2, 2, 3), 6), ((2, 4, 4, 36), 40)]


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
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def _assert_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(_bits(got), _bits(want))


def _special(rng, shape, dtype, device):
    """Normal values with some NaN, ±inf and signed zeros sprinkled in."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    picks = rng.choice(flat.size, size=max(1, flat.size // 64), replace=False)
    flat[picks] = rng.choice(np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32),
                             size=picks.size)
    return torch.from_numpy(x).to(device, DTYPES[dtype])


def _bias(rng, c, device):
    return torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)).to(device)


# -- nms_select ---------------------------------------------------------------

def _boxes(rng, shape):
    center = rng.uniform(0.2, 0.8, (*shape, 2)).astype(np.float32)
    half = rng.uniform(0.05, 0.2, (*shape, 2)).astype(np.float32)
    return center - half, center + half


@pytest.mark.cuda
@pytest.mark.parametrize("box_lead,n", [((8, 1), 845), ((8, 20), 845),
                                        ((2, 1), 2205), ((2, 1), 3645)])
def test_cuda_nms_select_matches_plain_version(rng, cuda_device, box_lead, n):
    """845 candidates at 416; 2205 (size 672) and 3645 (size 864) need more
    than the 48 KB of shared memory a block gets without opting in."""
    lead = (box_lead[0], 20)
    yx_min, yx_max = (torch.from_numpy(a).to(cuda_device) for a in _boxes(rng, (*box_lead, n)))
    scores = torch.from_numpy(rng.uniform(0, 1, (*lead, n)).astype(np.float32) ** 4)
    scores = scores.to(cuda_device)
    before = nk.nms_select.launches
    got = nk.nms_select(yx_min, yx_max, scores, 0.005, 0.45, 100)
    torch.cuda.synchronize()
    assert nk.nms_select.launches == before + 1
    assert nk.smem_limit(scores) >= nk.smem_bytes(3645) > 48 * 1024
    for g, w in zip(got, nms_plain(yx_min, yx_max, scores, 0.005, 0.45, 100)):
        assert torch.equal(g, w)


# -- maxpool2x2 ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROUTED_POOLS + POOL_EXTRA)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_maxpool_matches_plain_version(rng, cuda_device, shape, dtype):
    x = _special(rng, shape, dtype, cuda_device)
    before = pk.maxpool2x2.launches
    got = pk.maxpool2x2(x)
    torch.cuda.synchronize()
    assert pk.maxpool2x2.launches == before + 1
    _assert_bits(got, pk.maxpool2x2_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ROUTED_POOLS + POOL_EXTRA)
@pytest.mark.parametrize("act,full", [(True, False), (True, True), (False, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_maxpool_is_bit_identical_to_plain_version(rng, cuda_device, shape, act,
                                                              full, dtype):
    x = _special(rng, shape, dtype, cuda_device)
    bias = _bias(rng, shape[-1], cuda_device)
    before = pk.maxpool2x2.launches
    got = pk.maxpool2x2(x, bias, act, full)
    torch.cuda.synchronize()
    assert pk.maxpool2x2.launches == before + 1
    want = pk.maxpool2x2_plain(x, bias, act, full)
    if full:
        _assert_bits(got[0], want[0])
        _assert_bits(got[1], want[1])
    else:
        _assert_bits(got, want)


@pytest.mark.cuda
def test_cuda_fused_maxpool_of_a_misaligned_view_takes_the_one_lane_kernel(rng, cuda_device):
    base = _special(rng, (2 * 8 * 8 * 128 + 1,), "bfloat16", cuda_device)
    x = base[1:].view(2, 8, 8, 128)              # 2 bytes past a 16-byte boundary
    bias = _bias(rng, 128, cuda_device)
    got = pk.maxpool2x2(x, bias, True, True)
    want = pk.maxpool2x2_plain(x, bias, True, True)
    torch.cuda.synchronize()
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1])


# -- reorg_s2d -----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,ct", REORG_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_reorg_matches_plain_version(rng, cuda_device, shape, ct, dtype):
    x = _special(rng, shape, dtype, cuda_device)
    before = rk.reorg_s2d.launches
    got = rk.reorg_s2d(x, 2)
    torch.cuda.synchronize()
    assert rk.reorg_s2d.launches == before + 1
    _assert_bits(got, ops_reorg.reorg_s2d(x, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ct", REORG_CASES)
@pytest.mark.parametrize("bias,tail,act", [(True, True, True), (True, True, False),
                                           (True, False, True), (False, True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_reorg_concat_is_bit_identical_to_plain_version(rng, cuda_device, shape, ct,
                                                                   bias, tail, act, dtype):
    b, h, w, _ = shape
    x = _special(rng, shape, dtype, cuda_device)
    t = _special(rng, (b, h // 2, w // 2, ct), dtype, cuda_device) if tail else None
    bs = _bias(rng, shape[-1], cuda_device) if bias else None
    before = rk.reorg_s2d.launches
    got = rk.reorg_s2d(x, 2, t, bs, act)
    torch.cuda.synchronize()
    assert rk.reorg_s2d.launches == before + 1
    _assert_bits(got, rk.reorg_s2d_plain(x, 2, t, bs, act))


# -- the routed forwards -------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["darknet-s2d", "tiny"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_routed_forward_is_bit_identical_to_the_unrouted_one(cuda_device, model_name,
                                                                  dtype):
    """Full width at 128²: the fused pool and reorg kernels change no value,
    so the raw head equals the forward without ``pool reorg`` bit for bit
    where cuDNN picks the same algorithms for both (f32, TF32 off)."""
    if model_name == "tiny":
        model = Tiny(anchors=np.ones((5, 2), np.float32), num_classes=20,
                     dtype=DTYPES[dtype], pallas=frozenset({"pool"}))
        launches = {"maxpool2x2": 2, "reorg_s2d": 0}
    else:
        model = Darknet(anchors=np.ones((5, 2), np.float32), num_classes=20,
                        dtype=DTYPES[dtype], pallas=frozenset({"pool", "reorg"}),
                        reorg_order="s2d")
        launches = {"maxpool2x2": 3, "reorg_s2d": 1}
    params, state = model.init(torch.Generator().manual_seed(0), device=cuda_device)
    folded = model.fold(params, state)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 128, 128, 3))
                         .astype(np.float32)).to(cuda_device)
    before = pk.maxpool2x2.launches, rk.reorg_s2d.launches
    with torch.inference_mode():
        got = model.apply_folded(folded, x)
        counts = (pk.maxpool2x2.launches - before[0], rk.reorg_s2d.launches - before[1])
        want = dataclasses.replace(model, pallas=frozenset()).apply_folded(folded, x)
    torch.cuda.synchronize()
    assert counts == (launches["maxpool2x2"], launches["reorg_s2d"])
    assert torch.isfinite(got).all()
    if dtype == "float32":
        _assert_bits(got, want)
    else:   # cuDNN may pick other bf16 algorithms for the two forwards
        diff = (got.float() - want.float()).abs().mean() / want.float().abs().mean()
        assert diff <= 0.01
