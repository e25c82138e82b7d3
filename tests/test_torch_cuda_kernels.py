"""The port's fused decode+NMS, dwconv3x3 and dwsep kernels on the card,
against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU interpret mode.  The file imports torch, numpy, pytest and
``yolojax_torch`` only, so it runs on a machine without JAX:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda_*.py

(``--noconftest``: ``tests/conftest.py`` sets JAX up for the CPU tests.)
``chip_smoke.py`` runs that command as a phase.

Tolerances: fused decode+NMS ``keep`` and pick order exact, conf rtol 1e-5
(2e-5 at C=80: the kernel's ``expf`` and torch's softmax round apart),
corners atol 1e-5; dwconv3x3 and dwsep f32 rtol/atol 1e-4, bf16 1e-2 (one
bf16 ulp: the plain convs sum in cuDNN's order); dwconv3x3 bit-identical to
its tap-order reference ``dwconv3x3_taps``.
"""

import numpy as np
import pytest
import torch

from yolojax_torch.kernels import dwconv as dk
from yolojax_torch.kernels import dwsep as sk
from yolojax_torch.kernels import postprocess_fused as pf
from yolojax_torch.ops.postprocess import postprocess_raw

TOL = {"float32": 1e-4, "bfloat16": 1e-2}


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


def _as(x, dtype, device):
    return torch.from_numpy(np.asarray(x, np.float32)).to(device, getattr(torch, dtype))


# -- fused decode + NMS ------------------------------------------------------

def _raw(rng, b, h, w, a, c, objectness=None):
    raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 2).astype(np.float32)
    if objectness is not None:   # bench density: background-dominated scores
        raw.reshape(b, h, w, a, 5 + c)[..., 4] += objectness
    return raw


def _assert_same_picks(got, want, conf_rtol):
    """got / want: PostProcessed; compares kept slots only."""
    got, want = ([t.float().cpu().numpy() if t.dtype != torch.bool else t.cpu().numpy()
                  for t in out] for out in (got, want))
    keep = want[3]
    np.testing.assert_array_equal(got[3], keep)
    np.testing.assert_allclose(np.where(keep, got[2], 0), np.where(keep, want[2], 0),
                               rtol=conf_rtol)
    for i, name in ((0, "yx_min"), (1, "yx_max")):
        np.testing.assert_allclose(np.where(keep[..., None], got[i], 0),
                                   np.where(keep[..., None], want[i], 0), atol=1e-5,
                                   err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,a,c,objectness", [
    (8, 13, 13, 5, 20, -6.0), (8, 13, 13, 5, 20, None), (8, 19, 19, 5, 20, -6.0),
    (2, 13, 13, 5, 80, None), (1, 4, 3, 2, 3, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(rng, cuda_device, b, h, w, a, c, objectness,
                                           dtype):
    anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
    raw = _as(_raw(rng, b, h, w, a, c, objectness), dtype, cuda_device)
    before = pf.postprocess_fused.launches
    got = pf.postprocess_fused(raw, anchors, 0.005, 0.45, 100)
    torch.cuda.synchronize()
    assert pf.postprocess_fused.launches == before + 1
    want = postprocess_raw(raw, anchors, 0.005, 0.45, 100)
    _assert_same_picks(got, want, 2e-5 if c == 80 else 1e-5)


# -- dwconv3x3 and dwsep -----------------------------------------------------

def _dw_inputs(rng, shape):
    c = shape[-1]
    return (rng.standard_normal(shape), rng.standard_normal((3, 3, c)) * 0.3,
            rng.standard_normal(c))


def _dwsep_inputs(rng, shape, cout):
    c = shape[-1]
    return (rng.standard_normal(shape), rng.standard_normal((3, 3, c)) * 0.2,
            rng.standard_normal(c), rng.standard_normal((c, cout)) * 0.2,
            rng.standard_normal(cout))


@pytest.mark.cuda
@pytest.mark.parametrize("stride,shape", [(1, (8, 104, 104, 128)), (2, (8, 52, 52, 256)),
                                          (2, (2, 27, 27, 128)), (1, (2, 13, 13, 72)),
                                          (2, (2, 13, 13, 36))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dwconv_matches_plain_version(rng, cuda_device, stride, shape, dtype):
    x, w, b = _dw_inputs(rng, shape)
    x, w = (_as(a, dtype, cuda_device) for a in (x, w))
    b = _as(b, "float32", cuda_device)
    before = dk.dwconv3x3.launches
    got = dk.dwconv3x3(x, w, b, stride)
    torch.cuda.synchronize()
    assert dk.dwconv3x3.launches == before + 1
    want = dk.dwconv3x3_plain(x, w, b, stride)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("stride,shape", [(1, (8, 104, 104, 128)), (2, (8, 104, 104, 128)),
                                          (1, (8, 52, 52, 256)), (2, (8, 52, 52, 256)),
                                          (1, (2, 37, 29, 128)), (2, (2, 13, 13, 72))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_is_bit_identical_to_the_taps_reference(rng, cuda_device, dtype, stride,
                                                            shape):
    x, w, b = _dw_inputs(rng, shape)
    x, w = (_as(a, dtype, cuda_device) for a in (x, w))
    b = _as(b, "float32", cuda_device)
    got = dk.dwconv3x3(x, w, b, stride)
    want = dk.dwconv3x3_taps(x, w, b, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stride,shape,cout", [(1, (8, 26, 26, 512), 512),
                                               (2, (8, 26, 26, 512), 1024),
                                               (1, (8, 13, 13, 1024), 1024),
                                               (2, (8, 27, 27, 64), 96), (1, (2, 13, 13, 72), 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dwsep_matches_plain_version(rng, cuda_device, stride, shape, cout, dtype):
    x, wd, bd, wp, bp = _dwsep_inputs(rng, shape, cout)
    x, wd, wp = (_as(a, dtype, cuda_device) for a in (x, wd, wp))
    bd, bp = (_as(a, "float32", cuda_device) for a in (bd, bp))
    before = sk.dwsep.launches
    got = sk.dwsep(x, wd, bd, wp, bp, stride)
    torch.cuda.synchronize()
    assert sk.dwsep.launches == before + 1
    want = sk.dwsep_plain(x, wd, bd, wp, bp, stride)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,c,cout", [(3, 13, 1024, 1024), (128, 26, 512, 512)])
def test_cuda_dwsep_bf16_at_ragged_and_full_batch(rng, cuda_device, b, h, c, cout):
    """B=3 at 13×13 leaves a last pixel tile that is not full (507 pixels);
    B=128 is the main path's throughput batch.  With and without the engine's
    (Cout, C) copy of the weights."""
    x, wd, bd, wp, bp = _dwsep_inputs(rng, (b, h, h, c), cout)
    x, wd, wp = (_as(a, "bfloat16", cuda_device) for a in (x, wd, wp))
    bd, bp = (_as(a, "float32", cuda_device) for a in (bd, bp))
    want = sk.dwsep_plain(x, wd, bd, wp, bp, 1)
    for wp_t in (None, wp.t().contiguous()):
        got = sk.dwsep(x, wd, bd, wp, bp, 1, wp_t)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match="wp_t"):
        sk.dwsep(x, wd, bd, wp, bp, 1, wp.t())                   # not contiguous
