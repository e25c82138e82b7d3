"""Port parity: the one-pass bias + leaky epilogue (``kernels/epilogue.py``).

On the CPU the wrapper runs its plain version, ``blocks.bias_leaky`` on the
NCHW view; it is held bit for bit to ``bias_leaky`` and to the JAX engine's
folded epilogue ``_post_conv`` (one f32 add, one f32 multiply, one rounding
on both sides), and on the first C channels of a padded tensor (the raw
output of a conv the engine runs at a padded width) to itself on the same
values made contiguous.  The epilogues each path's route sends to the wrapper are
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


@pytest.mark.parametrize("c,padded", [(125, 128), (13, 16), (3, 8), (28269, 28272)])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_on_a_padded_view_is_itself_on_the_unpadded_tensor(rng, c, padded, act,
                                                                         dtype):
    """A (B, H, W, padded) tensor's first c channels, as the engine hands a
    padded conv's raw output over: the wrapper and its plain version give
    the contiguous result of the same values made contiguous, bit for bit."""
    tdtype = DTYPES[dtype][0]
    b, h, w = (1, 2, 3) if c > 1024 else (2, 5, 3)
    x = _special(rng, (b, h, w, padded), tdtype)[..., :c]
    assert not x.is_contiguous() and ek.pixel_stride(x) == padded
    bias = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32))
    want = ek.bias_leaky_nhwc_plain(x.contiguous(), bias, act)
    bits = torch.int32 if dtype == "float32" else torch.int16
    for fn in (ek.bias_leaky_nhwc_plain, ek.bias_leaky_nhwc):
        got = fn(x, bias, act)
        assert got.shape == (b, h, w, c) and got.dtype == tdtype and got.is_contiguous()
        assert torch.equal(got.view(bits), want.view(bits))


def test_pixel_stride_reads_contiguous_and_padded_layouts_only():
    base = torch.zeros(2, 3, 4, 16)
    assert ek.pixel_stride(base) == 16
    assert ek.pixel_stride(base[..., :13]) == 16
    assert ek.pixel_stride(base[:1, :1, :1, :5]) == 5      # one pixel: contiguous
    assert ek.pixel_stride(base[:, :1, :1, :5]) == 16 * 12  # one pixel an image
    # the engine's view: a channels_last NCHW conv output, permuted, its first C channels
    nchw = torch.zeros(2, 128, 3, 1).contiguous(memory_format=torch.channels_last)
    assert ek.pixel_stride(nchw.permute(0, 2, 3, 1)[..., :125]) == 128
    assert ek.pixel_stride(torch.zeros(2, 3, 4, 10)[..., :7]) is None    # 10: no multiple of 8
    assert ek.pixel_stride(base[:, :, ::2, :13]) == 32                     # every other pixel
    assert ek.pixel_stride(base[:, :, :2, :13]) is None                   # a row's end skipped
    assert ek.pixel_stride(base[:, :2, :, :13]) is None                   # an image's rows
    assert ek.pixel_stride(base[..., 1:14]) == 16                          # offset start
    assert ek.pixel_stride(base.permute(0, 3, 1, 2)) is None
    ek._check(base[..., :13], torch.zeros(13))
    with pytest.raises(ValueError, match="contiguous as NHWC"):
        ek._check(torch.zeros(2, 3, 4, 10)[..., :7], torch.zeros(7))


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


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_op_fake_gives_the_wrappers_shape_and_dtype(dtype, padded):
    x, bias = torch.zeros(2, 5, 3, 128 if padded else 125, dtype=dtype), torch.zeros(125)
    x = x[..., :125]
    want = ek.bias_leaky_nhwc(x, bias, True)
    with FakeTensorMode() as mode:
        fake = ops.bias_leaky_nhwc(mode.from_tensor(x), mode.from_tensor(bias), True)
    assert (fake.shape, fake.dtype, fake.stride()) == (want.shape, want.dtype, want.stride())
    assert torch.equal(ops.bias_leaky_nhwc(x, bias, True), want)
