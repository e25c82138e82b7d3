"""Port parity: the one-pass bias + leaky epilogue (``kernels/epilogue.py``).

On the CPU the wrapper runs its plain version, ``blocks.bias_leaky`` on the
NCHW view; it is held bit for bit to ``bias_leaky`` and to the JAX engine's
folded epilogue ``_post_conv`` (one f32 add, one f32 multiply, one rounding
on both sides).  The epilogues each path's route sends to the wrapper are
counted in ``tests/test_torch_route.py``.  On the card the kernel is held to
its plain version in ``tests/test_torch_cuda_bias_leaky.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from yolojax.models.engine import _post_conv
from yolojax_torch.kernels import epilogue as ek
from yolojax_torch.kernels import ops
from yolojax_torch.models.blocks import bias_leaky

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _special(rng, shape, dtype):
    """Normal values with some NaN, ±inf, signed zeros and f32 subnormals."""
    x = rng.standard_normal(shape).astype(np.float32) * 4
    flat = x.reshape(-1)
    picks = rng.choice(flat.size, size=max(1, flat.size // 32), replace=False)
    flat[picks] = rng.choice(np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-39, -1e-39],
                                      np.float32), size=picks.size)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("c", [32, 64, 125, 1024])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_path_is_bias_leaky_and_the_jax_epilogue_bit_for_bit(rng, c, act, dtype):
    tdtype, jdtype = DTYPES[dtype]
    x = _special(rng, (2, 5, 3, c), tdtype)
    bias = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32))
    got = ek.bias_leaky_nhwc(x, bias, act)
    want = bias_leaky(x.permute(0, 3, 1, 2), bias, act).permute(0, 2, 3, 1)
    assert got.dtype == tdtype and got.shape == x.shape and got.is_contiguous()
    bits = torch.int32 if dtype == "float32" else torch.int16
    assert torch.equal(got.view(bits), want.contiguous().view(bits))
    jx = jnp.asarray(x.float().numpy(), jdtype)
    jy, _ = _post_conv({"b": jnp.asarray(bias.numpy())}, {}, jx, bn=None, act=act,
                       compute_dtype=jdtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jy, np.float32))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        ek.bias_leaky_nhwc(x.to("meta"), torch.zeros(8, device="meta"))
    # the checks the CUDA path runs before it launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ek._check(x.double(), torch.zeros(8))
    with pytest.raises(ValueError, match="contiguous as NHWC"):
        ek._check(x.permute(0, 3, 1, 2), torch.zeros(8))
    with pytest.raises(ValueError, match="bias"):
        ek._check(x, torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="bias"):
        ek._check(x, torch.zeros(4))
    with pytest.raises(ValueError, match="2\\^31 pixels"):
        ek._check(torch.empty(2**16, 2**15, 1, 0), torch.zeros(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_op_fake_gives_the_wrappers_shape_and_dtype(dtype):
    x, bias = torch.zeros(2, 5, 3, 125, dtype=dtype), torch.zeros(125)
    want = ek.bias_leaky_nhwc(x, bias, True)
    with FakeTensorMode() as mode:
        fake = ops.bias_leaky_nhwc(mode.from_tensor(x), mode.from_tensor(bias), True)
    assert (fake.shape, fake.dtype, fake.stride()) == (want.shape, want.dtype, want.stride())
    assert torch.equal(ops.bias_leaky_nhwc(x, bias, True), want)
