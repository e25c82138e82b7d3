"""The port's one-pass bias + leaky epilogue kernel (``csrc/bias_leaky.cu``)
on the card, against its plain version, on contiguous inputs and on the
first C channels of a padded tensor (a padded conv's raw output), and the
bench's folded forwards that route every unfused epilogue through it.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU interpret mode.  The file imports torch, numpy, pytest and
``yolojax_torch`` only, so it runs on a machine without JAX (the command is
in ``tests/test_torch_cuda_kernels.py``).

All comparisons are exact, bit for bit: the kernel runs
``blocks.bias_leaky``'s f32 steps in the same order (built with
``--fmad=false``) and rounds as torch's cast on the card does.  The inputs
carry NaN, ±inf, signed zeros and subnormals, and values whose leaky product
is subnormal, so that the epilogue's signs and its rounding at the edges
are held too.
"""

import numpy as np
import pytest
import torch

from yolojax_torch.kernels import epilogue as ek
from yolojax_torch.models.blocks import bias_leaky
from yolojax_torch.models.darknet import Darknet
from yolojax_torch.models.inference import Inference
from yolojax_torch.models.mobilenet import MobileNet

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (H, C) of every conv output whose epilogue the kernel takes at 416 on the
# bench's two configurations: Darknet-19 c1-c22 (act) and its head `out`
# (125 channels, no act: the one-lane kernel), MobileNet's stem, dw1, dw2,
# pw1-pw6, c19-c22 and out
BENCH_CONVS = sorted({(416, 32), (208, 64), (104, 128), (104, 64), (52, 256), (52, 128),
                      (26, 512), (26, 256), (13, 1024), (13, 512), (26, 64), (208, 32)})
HEAD = (13, 125)


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


def _special(shape, dtype, seed):
    """Normal values on the card with one in 64 replaced by NaN, ±inf,
    signed zeros, f32 subnormals or values whose leaky product is one."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 4
    flat = x.view(-1)
    table = torch.tensor([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-39, -1e-39, -1e-37, -3e-38],
                         device="cuda")
    picks = torch.randint(0, flat.numel(), (max(1, flat.numel() // 64),), generator=g,
                          device="cuda")
    flat[picks] = table[torch.randint(0, len(table), picks.shape, generator=g, device="cuda")]
    return x.to(dtype)


def _bias(c, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(c, generator=g, device="cuda") * 0.5


def _plain(x, bias, act):
    return bias_leaky(x.permute(0, 3, 1, 2), bias, act).permute(0, 2, 3, 1)


def _check(x, bias, act):
    before = ek.bias_leaky_nhwc.launches
    got = ek.bias_leaky_nhwc(x, bias, act)
    torch.cuda.synchronize()
    assert ek.bias_leaky_nhwc.launches == before + 1
    assert got.is_contiguous()
    _assert_bits(got, _plain(x, bias, act).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("hc", BENCH_CONVS + [HEAD])
def test_cuda_bias_leaky_is_bit_identical_on_every_bench_conv(cuda_device, hc, b):
    h, c = hc
    x = _special((b, h, h, c), torch.bfloat16, seed=h * c + b)
    _check(x, _bias(c, seed=c), act=hc != HEAD)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 416, 416, 32), (128, 13, 13, 1024), (8, 13, 13, 125),
                                   (2, 26, 26, 64), (3, 5, 7, 6)])
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bias_leaky_matches_plain_version(cuda_device, shape, act, dtype):
    """f32 (four lanes a pack) and bf16, with and without leaky; C = 125
    and 6 take the one-lane kernel (6 is no whole pack in either dtype)."""
    _check(_special(shape, DTYPES[dtype], seed=len(shape) + shape[-1]),
           _bias(shape[-1], seed=1), act)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bias_leaky_of_a_misaligned_view_takes_the_one_lane_kernel(cuda_device, dtype):
    base = _special((2 * 13 * 13 * 1024 + 1,), DTYPES[dtype], seed=5)
    x = base[1:].view(2, 13, 13, 1024)            # one element past a 16-byte boundary
    _check(x, _bias(1024, seed=6), True)
    bias = _bias(1025, seed=7)[1:]                # a misaligned bias, aligned x
    _check(_special((2, 13, 13, 1024), DTYPES[dtype], seed=8), bias, True)


# (B, H, W, padded width, C): YOLO9000's head at 544 and the VOC head at 416
# (the engine's padded convs), and small odd widths, one of them under a pack
PADDED = [(8, 17, 17, 28272, 28269), (8, 13, 13, 128, 125), (128, 13, 13, 128, 125),
          (3, 5, 7, 16, 13), (2, 3, 3, 8, 3), (2, 4, 4, 24, 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PADDED)
@pytest.mark.parametrize("act", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bias_leaky_on_a_padded_view_is_bit_identical(cuda_device, shape, act, dtype):
    """The first C channels of a (B, H, W, padded) tensor: the padded
    instantiation's result equals the plain version's and the kernel's own
    on the same values made contiguous (the unpadded launch), bit for bit."""
    b, h, w, padded, c = shape
    x = _special((b, h, w, padded), DTYPES[dtype], seed=padded + c)[..., :c]
    assert ek.pixel_stride(x) == padded
    bias = _bias(c, seed=c)
    _check(x, bias, act)
    torch.cuda.synchronize()
    _assert_bits(ek.bias_leaky_nhwc(x, bias, act), ek.bias_leaky_nhwc(x.contiguous(), bias, act))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bias_leaky_of_a_misaligned_padded_view_takes_values_one_at_a_time(cuda_device,
                                                                               dtype):
    base = _special((2 * 17 * 17 * 136 + 1,), DTYPES[dtype], seed=9)
    x = base[1:].view(2, 17, 17, 136)[..., :131]     # x one value past a 16-byte boundary
    _check(x, _bias(131, seed=10), False)
    bias = _bias(132, seed=11)[1:]                    # a misaligned bias, aligned x
    _check(_special((2, 17, 17, 136), DTYPES[dtype], seed=12)[..., :131], bias, True)


@pytest.mark.cuda
def test_cuda_bias_leaky_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros(2, 4, 4, 8, device="cuda")
    with pytest.raises(TypeError):
        ek.bias_leaky_nhwc(x.double(), torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError):
        ek.bias_leaky_nhwc(x.permute(0, 3, 1, 2), torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError):                 # pixels 12 values apart: no multiple of 8
        ek.bias_leaky_nhwc(torch.zeros(2, 4, 4, 12, device="cuda")[..., :7],
                           torch.zeros(7, device="cuda"))
    with pytest.raises(ValueError):
        ek.bias_leaky_nhwc(x, torch.zeros(8))                      # bias on the CPU
    with pytest.raises(ValueError):
        ek.bias_leaky_nhwc(x, torch.zeros(8, device="cuda", dtype=torch.bfloat16))


# (model, pallas tokens): the bench's two paths; each forward launches the
# epilogues its route gives (``Inference.launches``)
FORWARDS = {"darknet": (Darknet, {"nms", "fusedpost"}),
            "mobilenet": (MobileNet, {"nms", "fusedpost", "dwsep", "dwconv"})}


@pytest.mark.cuda
@pytest.mark.parametrize("name", FORWARDS)
def test_cuda_folded_forward_is_bit_identical_to_the_plain_epilogues(cuda_device, monkeypatch,
                                                                     name):
    """Full width at 416, B=8, bf16: the forward with every unfused epilogue
    on the kernel equals the same forward with ``bias_leaky`` in its place,
    bit for bit (the same cuDNN calls, deterministic algorithms)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cls, pallas = FORWARDS[name]
    model = cls(anchors=np.ones((5, 2), np.float32), num_classes=20, dtype=torch.bfloat16,
                pallas=frozenset(pallas))
    launches = Inference(model).launches(416, post=False)["bias_leaky_nhwc"]
    params, state = model.init(torch.Generator().manual_seed(0), device=cuda_device)
    folded = model.fold(params, state)
    x = torch.rand(8, 416, 416, 3, generator=torch.Generator(device="cuda").manual_seed(1),
                   device="cuda")
    before = ek.bias_leaky_nhwc.launches
    with torch.inference_mode():
        got = model.apply_folded(folded, x)
        torch.cuda.synchronize()
        assert ek.bias_leaky_nhwc.launches - before == launches
        monkeypatch.setattr(ek, "bias_leaky_nhwc", ek.bias_leaky_nhwc_plain)
        want = model.apply_folded(folded, x)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _assert_bits(got, want)
