"""The tap-order reference of the depthwise 3×3 kernel.

``kernels/dwconv.py::dwconv3x3_taps`` is the CUDA kernel's arithmetic in
separate torch ops: an f32 sum from 0 over the nine shifted slices of the
zero-padded input, dy outer and dx inner, each a product then an add; the
sum rounded to the compute dtype, then + bias and leaky in f32, rounded
again.  On the card the kernel must be bit-identical to it (the test marked
``cuda`` below, and ``chip_smoke.py``).  Here it is held:

* bit for bit to the same order written in numpy float32 (each ``*`` and
  ``+`` one IEEE rounding, no fused multiply-add);
* to ``dwconv3x3_plain`` (the grouped conv, which sums in its own order):
  f32 rtol/atol 1e-5, bf16 rtol/atol 1e-2 (one bf16 ulp: a sum next to a
  rounding boundary may round the other way);
* to the JAX package's ``dwconv3x3_pallas`` in interpret mode with the
  engine's folded epilogue: the same bounds (XLA on the CPU may fuse a
  product and an add, which rounds once less).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from yolojax.kernels.dwconv import dwconv3x3_pallas
from yolojax_torch.kernels import dwconv as dk

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
CASES = [(1, (1, 16, 16, 8)), (2, (2, 16, 16, 8)), (1, (2, 13, 13, 128)),
         (2, (1, 13, 13, 128)), (2, (1, 12, 12, 8)), (1, (1, 5, 9, 16)), (2, (1, 9, 5, 16))]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(rng, shape, dtype):
    c = shape[-1]
    tdt = DTYPES[dtype][0]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(tdt)
    w = torch.from_numpy((rng.standard_normal((3, 3, c)) * 0.3).astype(np.float32)).to(tdt)
    return x, w, torch.from_numpy(rng.standard_normal(c).astype(np.float32))


def _numpy_order(x, w, b, stride, act):
    """The tap order in numpy float32 on the widened inputs."""
    xf, wf, bf = (t.float().numpy() for t in (x, w, b))
    bsz, h, wd, c = xf.shape
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    xp = np.pad(xf, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((bsz, ho, wo, c), np.float32)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            acc = acc + patch * wf[dy, dx]
    z = torch.from_numpy(acc).to(x.dtype).float().numpy() + bf
    if act:
        z = np.where(z >= 0, z, np.float32(0.1) * z)
    return torch.from_numpy(z.astype(np.float32)).to(x.dtype)


@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("stride,shape", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_taps_reference_is_the_tap_order_bit_for_bit(rng, dtype, stride, shape, act):
    x, w, b = _inputs(rng, shape, dtype)
    got = dk.dwconv3x3_taps(x, w, b, stride, act)
    want = _numpy_order(x, w, b, stride, act)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("stride,shape", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_taps_reference_matches_the_plain_version(rng, dtype, stride, shape):
    x, w, b = _inputs(rng, shape, dtype)
    got = dk.dwconv3x3_taps(x, w, b, stride)
    want = dk.dwconv3x3_plain(x, w, b, stride)
    assert got.shape == want.shape and got.dtype == want.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
    # the CPU wrapper is the plain version
    torch.testing.assert_close(dk.dwconv3x3(x, w, b, stride), want, rtol=0, atol=0)


@pytest.mark.parametrize("stride,shape", CASES[:5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_taps_reference_matches_the_pallas_kernel(rng, dtype, stride, shape):
    x, w, b = _inputs(rng, shape, dtype)
    jdt = DTYPES[dtype][1]
    with pltpu.force_tpu_interpret_mode():
        y = dwconv3x3_pallas(jnp.asarray(x.float().numpy(), jdt),
                             jnp.asarray(w.float().numpy(), jdt), stride)
    z = y.astype(jnp.float32) + b.numpy()
    want = np.asarray(jnp.where(z >= 0, z, 0.1 * z).astype(jdt).astype(jnp.float32))
    got = dk.dwconv3x3_taps(x, w, b, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("stride,shape", [(1, (8, 104, 104, 128)), (2, (8, 104, 104, 128)),
                                          (1, (8, 52, 52, 256)), (2, (8, 52, 52, 256)),
                                          (1, (2, 37, 29, 128)), (2, (2, 13, 13, 72))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_is_bit_identical_to_the_taps_reference(rng, cuda_device, dtype, stride,
                                                            shape):
    x, w, b = (t.to(cuda_device) for t in _inputs(rng, shape, dtype))
    got = dk.dwconv3x3(x, w, b, stride)
    want = dk.dwconv3x3_taps(x, w, b, stride)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
