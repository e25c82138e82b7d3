"""Port parity: the one-pass bias + leaky epilogue (``kernels/epilogue.py``)
and the folded walk's routing into it.

On the CPU the wrapper runs its plain version, ``blocks.bias_leaky`` on the
NCHW view; it is held bit for bit to ``bias_leaky`` and to the JAX engine's
folded epilogue ``_post_conv`` (one f32 add, one f32 multiply, one rounding
on both sides).  The routing test walks each bench path's plan at 416 with
the convolutions and depthwise kernels replaced by zeros of their output
shapes (the count of epilogues depends on the shapes alone) and counts the
epilogues each route takes.  On the card the kernel is held to its plain
version in ``tests/test_torch_cuda_bias_leaky.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from yolojax.models.engine import _post_conv
from yolojax_torch.kernels import dwconv as dk
from yolojax_torch.kernels import dwsep as sk
from yolojax_torch.kernels import epilogue as ek
from yolojax_torch.kernels import ops
from yolojax_torch.kernels import pool as pk
from yolojax_torch.kernels import reorg as rk
from yolojax_torch.models import engine
from yolojax_torch.models.blocks import bias_leaky
from yolojax_torch.models.darknet import Darknet, Tiny
from yolojax_torch.models.mobilenet import MobileNet

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


# -- the folded walk's routing --------------------------------------------------

def _zeros_like_conv(x, w, *, stride=1, groups=1):
    k = w.shape[-1]
    h, wd = ((n + 2 * (k // 2) - k) // stride + 1 for n in x.shape[2:])
    return x.new_zeros((x.shape[0], w.shape[0], h, wd)).contiguous(
        memory_format=torch.channels_last)


def _zeros_dwconv(x, w, b, stride=1, act=True):
    b_, h, wd, c = x.shape
    return x.new_zeros((b_, (h - 1) // stride + 1, (wd - 1) // stride + 1, c))


def _zeros_dwsep(x, wd, bd, wp, bp, stride=1, wp_t=None):
    b_, h, w, _ = x.shape
    return x.new_zeros((b_, (h - 1) // stride + 1, (w - 1) // stride + 1, wp.shape[1]))


# (model, pallas tokens, extra fields) -> epilogues on the wrapper per forward,
# the bench's paths and the two fused-pool paths (PERF.md §4): every conv → 2×2/2
# pair's epilogue runs in the pool kernel, whatever the tokens (Darknet's five,
# Tiny's c1-c5), the s2d reorg takes c21's
ROUTES = {
    "darknet": (Darknet, {"nms", "fusedpost"}, {}, 18),
    "darknet-s2d": (Darknet, {"nms", "pool", "reorg"}, {"reorg_order": "s2d"}, 17),
    "tiny": (Tiny, {"nms", "fusedpost", "pool"}, {}, 4),
    "mobilenet": (MobileNet, {"nms", "fusedpost", "dwsep", "dwconv"}, {}, 14),
}


@pytest.mark.parametrize("name", ROUTES)
def test_folded_walk_sends_every_unfused_epilogue_through_the_wrapper(monkeypatch, name):
    cls, pallas, kw, want = ROUTES[name]
    model = cls(anchors=np.ones((5, 2), np.float32), num_classes=20, dtype=torch.float32,
                pallas=frozenset(pallas), **kw)
    folded = model.fold(*model.init(torch.Generator().manual_seed(0)))
    calls = {}

    def counted(module, attr, fn, layers=1):
        def spy(*args):
            calls[attr] = calls.get(attr, 0) + layers
            return fn(*args)
        monkeypatch.setattr(module, attr, spy)

    monkeypatch.setattr(engine, "conv", _zeros_like_conv)
    counted(ek, "bias_leaky_nhwc", ek.bias_leaky_nhwc)
    counted(dk, "dwconv3x3", _zeros_dwconv)
    counted(sk, "dwsep", _zeros_dwsep, layers=2)
    counted(pk, "maxpool2x2", pk.maxpool2x2)
    counted(rk, "reorg_s2d", rk.reorg_s2d)
    with torch.no_grad():
        out = model.apply_folded(folded, torch.zeros(1, 416, 416, 3))
    assert out.shape == (1, 13, 13, 125)
    assert calls["bias_leaky_nhwc"] == want
    # every conv's epilogue ran once: in the wrapper or in the kernel that took it
    taken = sum(calls.get(k, 0) for k in ("maxpool2x2", "reorg_s2d", "dwconv3x3", "dwsep"))
    assert want + taken == len(model.layer_defs)
