"""Port parity, kernels: the depthwise wrappers of yolojax_torch.

On the CPU each wrapper runs its plain version; it is held against the JAX
package's Pallas kernel run in interpret mode, as tests/test_kernels.py runs
it.  ``dwconv3x3_pallas`` computes the conv alone, so the JAX side adds the
engine's folded epilogue (``_post_conv``: f32 + b, leaky, cast back).
Tolerances: f32 rtol/atol 1e-4 (the JAX tests' bound, tests/test_kernels.py
:96, :260: nine taps and a C-term pointwise sum in other orders); bf16
rtol/atol 1e-2, about one bf16 ulp, because a sum that lands next to a
rounding boundary may round the other way.  The CUDA kernels are compared
with their plain versions in the tests marked ``cuda``, which skip without
a card.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from yolojax.kernels.dwconv import dwconv3x3_pallas
from yolojax.kernels.dwsep import dwsep_pallas
from yolojax_torch.kernels import _build
from yolojax_torch.kernels import dwconv as dk
from yolojax_torch.kernels import dwsep as sk

TOL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _leaky(v):
    return jnp.where(v >= 0, v, 0.1 * v)


def _dw_inputs(rng, shape):
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal((3, 3, c)) * 0.3).astype(np.float32),
            rng.standard_normal(c).astype(np.float32))


def _dwsep_inputs(rng, shape, cout):
    c = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal((3, 3, c)) * 0.2).astype(np.float32),
            rng.standard_normal(c).astype(np.float32),
            (rng.standard_normal((c, cout)) * 0.2).astype(np.float32),
            rng.standard_normal(cout).astype(np.float32))


def _as(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("stride,shape,dtype", [
    (1, (1, 16, 16, 8), "float32"), (2, (2, 16, 16, 8), "float32"),
    (1, (1, 13, 13, 8), "float32"), (2, (1, 13, 13, 8), "float32"),
    (1, (2, 12, 12, 128), "float32"), (2, (1, 13, 13, 128), "float32"),
    (1, (2, 13, 13, 128), "bfloat16"),
])
def test_dwconv_plain_matches_pallas_kernel(rng, stride, shape, dtype):
    x, w, b = _dw_inputs(rng, shape)
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        y = dwconv3x3_pallas(jnp.asarray(x, jdt), jnp.asarray(w, jdt), stride)
    want = _leaky(y.astype(jnp.float32) + b).astype(jdt)
    got = dk.dwconv3x3(_as(x, dtype), _as(w, dtype), torch.from_numpy(b), stride, True)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("stride,shape,cout,dtype", [
    (1, (2, 12, 12, 16), 32, "float32"), (2, (4, 12, 12, 16), 32, "float32"),
    (1, (1, 9, 9, 8), 8, "float32"),                # odd spatial
    (2, (8, 13, 13, 16), 8, "float32"),             # odd spatial under stride 2
    (1, (2, 26, 26, 8), 16, "float32"), (2, (2, 27, 27, 8), 16, "float32"),
    (1, (2, 13, 13, 128), 64, "bfloat16"),
])
def test_dwsep_plain_matches_pallas_kernel(rng, stride, shape, cout, dtype):
    x, wd, bd, wp, bp = _dwsep_inputs(rng, shape, cout)
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = dwsep_pallas(jnp.asarray(x, jdt), jnp.asarray(wd, jdt), jnp.asarray(bd),
                            jnp.asarray(wp, jdt), jnp.asarray(bp), stride)
    got = sk.dwsep(_as(x, dtype), _as(wd, dtype), torch.from_numpy(bd), _as(wp, dtype),
                   torch.from_numpy(bp), stride)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_dwconv_without_act_is_conv_plus_bias(rng):
    x, w, b = _dw_inputs(rng, (1, 9, 9, 8))
    got = dk.dwconv3x3(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1, False)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w).reshape(3, 3, 1, 8), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=8) + b
    assert (got < 0).any()
    _close(got, want, "float32")


def test_cpu_tensors_take_plain_versions_without_launch(rng):
    x, wd, bd, wp, bp = (torch.from_numpy(a) for a in _dwsep_inputs(rng, (1, 6, 6, 8), 4))
    before = dk.dwconv3x3.launches, sk.dwsep.launches
    got = dk.dwconv3x3(x, wd, bd, 2)
    torch.testing.assert_close(got, dk.dwconv3x3_plain(x, wd, bd, 2), rtol=0, atol=0)
    got = sk.dwsep(x, wd, bd, wp, bp, 1)
    torch.testing.assert_close(got, sk.dwsep_plain(x, wd, bd, wp, bp, 1), rtol=0, atol=0)
    assert (dk.dwconv3x3.launches, sk.dwsep.launches) == before


def test_unsupported_device_raises():
    x = torch.empty((1, 4, 4, 8), device="meta")
    w, b = torch.empty((3, 3, 8), device="meta"), torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dk.dwconv3x3(x, w, b)
    with pytest.raises(ValueError, match="unsupported device"):
        sk.dwsep(x, w, b, torch.empty((8, 4), device="meta"), torch.empty((4,), device="meta"))


@pytest.mark.parametrize("case", ["dtype", "taps", "stride", "layout"])
def test_wrapper_checks_reject_what_the_kernels_do_not_take(case):
    x = torch.zeros((2, 5, 5, 8))
    wd, bd = torch.zeros((3, 3, 8)), torch.zeros(8)
    wp, bp = torch.zeros((8, 4)), torch.zeros(4)
    stride = 1
    if case == "dtype":
        x, error = x.half(), TypeError
    elif case == "taps":
        wd, error = torch.zeros((8, 1, 3, 3)), ValueError
    elif case == "stride":
        stride, error = 3, ValueError
    else:
        x, error = x.permute(0, 2, 1, 3), ValueError
    with pytest.raises(error):
        dk._check(x, wd, bd, stride)
    with pytest.raises(error):
        sk._check(x, wd, bd, wp, bp, stride)


@pytest.mark.parametrize("module", [dk, sk])
def test_failed_build_raises(tmp_path, monkeypatch, module):
    """A compiler failure is an error, never a silent fallback."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        module.build()
    assert not list(tmp_path.glob("*.so"))


def test_build_caches_each_source_under_its_hash(tmp_path, monkeypatch):
    """One library per source, named by its hash; a second build reuses it."""
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho x >> "$CALLS"\n'
                    'while [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi; shift\n'
                    'done\necho "ptxas info    : Used 8 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CALLS", str(calls))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    libs = _build.build_all([dk.SOURCE, sk.SOURCE])
    assert [lib.name.split("-")[0] for lib in libs] == ["dwconv3x3", "dwsep"]
    assert all(lib.exists() and "Used 8 registers" in lib.with_suffix(".log").read_text()
               for lib in libs)
    assert dk.build() == libs[0] and sk.build() == libs[1]
    assert len(calls.read_text().split()) == 2                 # no second nvcc run


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stride,shape", [(1, (8, 104, 104, 128)), (2, (8, 52, 52, 256)),
                                          (2, (2, 27, 27, 128)), (1, (2, 13, 13, 72)),
                                          (2, (2, 13, 13, 36))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dwconv_matches_plain_version(rng, cuda_device, stride, shape, dtype):
    x, w, b = _dw_inputs(rng, shape)
    x, w = (_as(a, dtype).to(cuda_device) for a in (x, w))
    b = torch.from_numpy(b).to(cuda_device)
    before = dk.dwconv3x3.launches
    got = dk.dwconv3x3(x, w, b, stride)
    torch.cuda.synchronize()
    assert dk.dwconv3x3.launches == before + 1
    want = dk.dwconv3x3_plain(x, w, b, stride)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("stride,shape,cout", [(1, (8, 26, 26, 512), 512),
                                               (2, (8, 26, 26, 512), 1024),
                                               (1, (8, 13, 13, 1024), 1024),
                                               (2, (8, 27, 27, 64), 96), (1, (2, 13, 13, 72), 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_dwsep_matches_plain_version(rng, cuda_device, stride, shape, cout, dtype):
    x, wd, bd, wp, bp = _dwsep_inputs(rng, shape, cout)
    x, wd, wp = (_as(a, dtype).to(cuda_device) for a in (x, wd, wp))
    bd, bp = (torch.from_numpy(a).to(cuda_device) for a in (bd, bp))
    before = sk.dwsep.launches
    got = sk.dwsep(x, wd, bd, wp, bp, stride)
    torch.cuda.synchronize()
    assert sk.dwsep.launches == before + 1
    want = sk.dwsep_plain(x, wd, bd, wp, bp, stride)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# -- the shared launch path and the bf16 kernel's layouts --------------------

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_launch_helper_raises_off_cuda(device, tmp_path, monkeypatch):
    """The shared launch path takes CUDA tensors only, and raises before it
    builds anything."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: pytest.fail("built for a non-CUDA tensor"))
    kernel = _build.Kernel(sk.SOURCE, "yolo_dwsep_bf16", [])
    with pytest.raises(ValueError, match="unsupported device"):
        kernel(torch.empty((1, 4, 4, 8), device=device))
    assert kernel._fn is None and not list(tmp_path.iterdir())


def test_bf16_channel_limit_is_checked():
    wd, bd = torch.zeros((3, 3, 1032), dtype=torch.bfloat16), torch.zeros(1032)
    wp, bp = torch.zeros((1032, 8), dtype=torch.bfloat16), torch.zeros(8)
    x = torch.zeros((1, 3, 3, 1032), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 1024"):
        sk._check(x, wd, bd, wp, bp, 1)
    sk._check(x[..., :1024].contiguous(), wd[..., :1024].contiguous(), bd[:1024],
              wp[:1024].contiguous(), bp, 1)
    sk._check(x.float(), wd.float(), bd, wp.float(), bp, 1)         # f32: no limit


def test_engine_stores_the_pointwise_weights_in_both_layouts():
    from yolojax_torch.models.mobilenet import MobileNet

    model = MobileNet(anchors=np.ones((5, 2), np.float32), num_classes=20,
                      dtype=torch.bfloat16, pallas=frozenset({"dwsep", "dwconv"}))
    folded = model.fold(*model.init(torch.Generator().manual_seed(0)))
    for name in ("pw7", "pw12", "pw13"):
        lq = folded[name]
        assert torch.equal(lq["w_oi"], lq["w"][:, :, 0, 0]) and lq["w_oi"].is_contiguous()
        assert torch.equal(lq["w_io"], lq["w"][:, :, 0, 0].t()) and lq["w_io"].is_contiguous()
    assert "w_oi" not in folded["pw2"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,c,cout", [(3, 13, 1024, 1024), (128, 26, 512, 512)])
def test_cuda_dwsep_bf16_at_ragged_and_full_batch(rng, cuda_device, b, h, c, cout):
    """B=3 at 13×13 leaves a last pixel tile that is not full (507 pixels);
    B=128 is the main path's throughput batch.  With and without the engine's
    (Cout, C) copy of the weights."""
    x, wd, bd, wp, bp = _dwsep_inputs(rng, (b, h, h, c), cout)
    x, wd, wp = (_as(a, "bfloat16").to(cuda_device) for a in (x, wd, wp))
    bd, bp = (torch.from_numpy(a).to(cuda_device) for a in (bd, bp))
    want = sk.dwsep_plain(x, wd, bd, wp, bp, 1)
    for wp_t in (None, wp.t().contiguous()):
        got = sk.dwsep(x, wd, bd, wp, bp, 1, wp_t)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
    with pytest.raises(ValueError, match="wp_t"):
        sk.dwsep(x, wd, bd, wp, bp, 1, wp.t())                   # not contiguous
