"""Port parity, kernels: the fused decode+NMS wrapper of yolojax_torch.

On the CPU the wrapper runs its plain version (decode → batched greedy NMS);
it is held against the JAX package's Pallas kernel ``postprocess_fused_pallas``
run in interpret mode, as tests/test_kernels.py runs it.  Tolerances: ``keep``
and pick order exact; conf rtol 1e-5 (2e-5 at C=80, where the Pallas kernel's
class-order softmax sum and the plain version's reduction round differently);
corners atol 1e-5 on kept slots.  The CUDA kernel itself is compared with
the plain version in the tests marked ``cuda``, which skip without a card.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from yolojax.kernels.nms import postprocess_fused_pallas
from yolojax_torch.kernels import _build
from yolojax_torch.kernels import postprocess_fused as pf
from yolojax_torch.ops.postprocess import postprocess_raw


def _raw(rng, b, h, w, a, c, objectness=None):
    raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 2).astype(np.float32)
    if objectness is not None:   # bench density: background-dominated scores
        raw.reshape(b, h, w, a, 5 + c)[..., 4] += objectness
    return raw


def _assert_same_picks(got, want, conf_rtol):
    """got / want: PostProcessed as numpy arrays; compares kept slots only."""
    keep = np.asarray(want.keep)
    np.testing.assert_array_equal(np.asarray(got.keep), keep)
    np.testing.assert_allclose(np.where(keep, np.asarray(got.conf), 0),
                               np.where(keep, np.asarray(want.conf), 0), rtol=conf_rtol)
    for name in ("yx_min", "yx_max"):
        np.testing.assert_allclose(np.where(keep[..., None], np.asarray(getattr(got, name)), 0),
                                   np.where(keep[..., None], np.asarray(getattr(want, name)), 0),
                                   atol=1e-5, err_msg=name)


def _numpy(out):
    return type(out)(*(t.float().cpu().numpy() if t.dtype != torch.bool else t.cpu().numpy()
                       for t in out))


@pytest.mark.parametrize("b,h,w,a,c,dtype", [
    (3, 13, 13, 5, 20, "float32"),   # VOC geometry
    (1, 4, 3, 2, 3, "float32"),      # odd grid, C not a multiple of 8
    (5, 2, 2, 1, 1, "float32"),      # single class (softmax degenerates to 1)
    (2, 4, 4, 5, 80, "float32"),     # COCO class count
    (2, 7, 7, 3, 4, "bfloat16"),     # bf16 head, the production compute dtype
])
def test_plain_version_matches_pallas_kernel(rng, b, h, w, a, c, dtype):
    import jax.numpy as jnp

    anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
    raw = _raw(rng, b, h, w, a, c)
    topk = 16
    with pltpu.force_tpu_interpret_mode():
        want = postprocess_fused_pallas(jnp.asarray(raw, dtype), anchors, 0.05, 0.45, topk)
    got = pf.postprocess_fused(torch.from_numpy(raw).to(getattr(torch, dtype)), anchors,
                               0.05, 0.45, topk)
    assert got.conf.shape == (b, c, topk) and got.yx_min.shape == (b, c, topk, 2)
    _assert_same_picks(_numpy(got), want, 2e-5 if c == 80 else 1e-5)


def test_cpu_tensor_takes_plain_version_without_launch(rng):
    anchors = rng.uniform(0.5, 4.0, (5, 2)).astype(np.float32)
    raw = torch.from_numpy(_raw(rng, 2, 13, 13, 5, 20, objectness=-6.0))
    before = pf.postprocess_fused.launches
    got = pf.postprocess_fused(raw, anchors, 0.005, 0.45, 100)
    assert pf.postprocess_fused.launches == before
    want = postprocess_raw(raw, anchors, 0.005, 0.45, 100)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_unsupported_device_raises():
    raw = torch.empty((1, 2, 2, 7), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pf.postprocess_fused(raw, np.ones((1, 2), np.float32), 0.1, 0.45, 4)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler failure is an error, never a silent fallback."""
    import shutil

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pf.build()
    assert not list(tmp_path.glob("*.so"))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel; no CPU interpret mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,a,c,objectness", [
    (8, 13, 13, 5, 20, -6.0), (8, 13, 13, 5, 20, None), (8, 19, 19, 5, 20, -6.0),
    (2, 13, 13, 5, 80, None), (1, 4, 3, 2, 3, None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(rng, cuda_device, b, h, w, a, c, objectness,
                                           dtype):
    anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
    raw = torch.from_numpy(_raw(rng, b, h, w, a, c, objectness)).to(cuda_device,
                                                                     getattr(torch, dtype))
    before = pf.postprocess_fused.launches
    got = pf.postprocess_fused(raw, anchors, 0.005, 0.45, 100)
    torch.cuda.synchronize()
    assert pf.postprocess_fused.launches == before + 1
    want = postprocess_raw(raw, anchors, 0.005, 0.45, 100)
    _assert_same_picks(_numpy(got), _numpy(want), 2e-5 if c == 80 else 1e-5)
