"""The port's eval path on the card: the fused decode+NMS kernel at eval's
operating point against its plain version, the one-copy ``to_host``, a
``.weights`` file loaded onto the card, and ``cli/eval.py::run_eval`` on the
card against the same eval on the CPU.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports torch, numpy, pytest and ``yolojax_torch`` only, so it runs on
a machine without JAX (``chip_smoke.py`` runs it with the other
``tests/test_torch_cuda_*.py``):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda_*.py

Eval's point is ``config.ini``'s ``[eval]``: threshold 0.005, topk 300, batch
16.  Tolerances: the fused kernel's ``keep`` and pick order exact, conf rtol
1e-5 (2e-5 at C=80), corners atol 1e-5, as at topk 100; the card's eval
against the CPU's, both f32 with TF32 off: mAP within 2e-3 absolute and each
class's AP within 1e-2 (the convolutions sum in other orders, about 1e-6
relative, so at threshold 0.005 a candidate may cross the threshold or two
may swap places in a ranking).
"""

import numpy as np
import pytest
import torch

from yolojax_torch.cli.common import build
from yolojax_torch.cli.eval import run_eval
from yolojax_torch.config import load_config
from yolojax_torch.data.cache import make_record
from yolojax_torch.kernels import postprocess_fused as pf
from yolojax_torch.models.inference import to_host
from yolojax_torch.ops.postprocess import postprocess_raw
from yolojax_torch.tools.darknet import load_weights, save_weights

THRESHOLD, OVERLAP, TOPK = 0.005, 0.45, 300


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


def _raw(rng, b, h, w, a, c, objectness=None):
    raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 2).astype(np.float32)
    if objectness is not None:   # bench density: background-dominated scores
        raw.reshape(b, h, w, a, 5 + c)[..., 4] += objectness
    return raw


def _host(out):
    return [t.float().cpu().numpy() if t.dtype != torch.bool else t.cpu().numpy() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,a,c", [(16, 13, 13, 5, 20), (16, 19, 19, 5, 20),
                                       (16, 13, 13, 5, 80), (16, 19, 19, 5, 80)])
@pytest.mark.parametrize("objectness", [-6.0, None], ids=["bench", "saturated"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_fused_matches_plain_version_at_the_eval_point(rng, cuda_device, b, h, w, a, c,
                                                            objectness, dtype):
    anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
    raw = torch.from_numpy(_raw(rng, b, h, w, a, c, objectness)).to(cuda_device,
                                                                    getattr(torch, dtype))
    before = pf.postprocess_fused.launches
    got = pf.postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
    torch.cuda.synchronize()
    assert pf.postprocess_fused.launches == before + 1
    want = _host(postprocess_raw(raw, anchors, THRESHOLD, OVERLAP, TOPK))
    got = to_host(got)
    keep = want[3]
    np.testing.assert_array_equal(got.keep, keep)
    np.testing.assert_allclose(np.where(keep, got.conf, 0), np.where(keep, want[2], 0),
                               rtol=2e-5 if c == 80 else 1e-5)
    for i, name in ((0, "yx_min"), (1, "yx_max")):
        np.testing.assert_allclose(np.where(keep[..., None], got[i], 0),
                                   np.where(keep[..., None], want[i], 0), atol=1e-5,
                                   err_msg=name)
    if objectness is None:          # saturated: at 608 every row fills its 300 slots
        assert keep.sum(-1).max() == TOPK if h == 19 else keep.sum(-1).max() > 100


@pytest.mark.cuda
def test_cuda_to_host_is_one_copy_of_the_fused_output(rng, cuda_device):
    raw = torch.from_numpy(_raw(rng, 4, 13, 13, 5, 20)).to(cuda_device)
    out = pf.postprocess_fused(raw, rng.uniform(0.5, 4.0, (5, 2)).astype(np.float32),
                               THRESHOLD, OVERLAP, TOPK)
    assert len({t.untyped_storage().data_ptr() for t in out}) == 1
    got = to_host(out)
    for g, t in zip(got, out):
        assert isinstance(g, np.ndarray) and g.dtype == t.cpu().numpy().dtype
        np.testing.assert_array_equal(g, t.cpu().numpy())


def _config(*mods):
    return load_config(None, ["model/dtype=float32", "data/workers=2", "data/canvas=256",
                              *mods])


@pytest.mark.cuda
def test_cuda_weights_load_onto_the_card(tmp_path, cuda_device):
    config = _config("model/dnn=yolojax.models.darknet.Tiny")
    _, _, model = build(config)
    params, state = model.init(torch.Generator().manual_seed(1), cuda_device)
    path = str(tmp_path / "tiny.weights")
    save_weights(path, model, params, state, seen=5)
    got, got_state, seen = load_weights(path, model, device=cuda_device)
    assert seen == 5
    for k, lp in params.items():
        for n, v in lp.items():
            assert got[k][n].is_cuda and torch.equal(got[k][n], v), (k, n)
    assert torch.equal(got_state["c1"]["var"], state["c1"]["var"])


def _dataset(rng, n: int):
    """``n`` images of 100-250 px with 1-4 filled rectangles each, and their
    records (VOC classes)."""
    images, records = {}, []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(100, 251, 2))
        img = np.empty((h, w, 3), np.uint8)
        img[:] = rng.integers(0, 256, 3, dtype=np.uint8)
        k = int(rng.integers(1, 5))
        lo = rng.uniform(0.0, 0.6, (k, 2))
        hi = np.minimum(lo + rng.uniform(0.2, 0.5, (k, 2)), 1.0)
        for (y0, x0), (y1, x1) in zip((lo * (h, w)).astype(int), (hi * (h, w)).astype(int)):
            img[y0:y1, x0:x1] = rng.integers(0, 256, 3, dtype=np.uint8)
        images[f"img/{i}"] = img
        records.append(make_record(f"img/{i}", lo, hi, rng.integers(0, 20, k),
                                   rng.uniform(size=k) < 0.2))
    return images, records


@pytest.mark.cuda
@pytest.mark.parametrize("pallas", ["nms fusedpost", "nms"])
def test_cuda_eval_matches_the_cpu(rng, cuda_device, pallas):
    """Full-width Darknet-19 at 128² on 20 images (a final partial batch of
    4), seeded weights with the objectness bias at +2 so that most candidates
    pass the threshold, on the card (the fused kernel, or nms_select) and on
    the CPU (the plain postprocess)."""
    config = _config(f"model/pallas={pallas}")
    category, _, model = build(config)
    params, state = model.init(torch.Generator().manual_seed(3))
    params["out"]["b"].view(5, 25)[:, 4] = 2.0
    images, records = _dataset(rng, 20)
    result = {}
    for device in ("cpu", cuda_device):
        on = lambda tree: {k: {n: v.to(device) for n, v in lp.items()} for k, lp in tree.items()}
        result[str(device)] = run_eval(config, model, on(params), on(state), records, 128, 16,
                                       category, imread=images.__getitem__)
    got, want = result[str(cuda_device)], result["cpu"]
    dets = lambda r: sum(len(d) for d in r["recorder"].dets.values())
    assert dets(want) > 1000 and abs(dets(got) - dets(want)) <= 0.01 * dets(want)
    assert abs(got["map"] - want["map"]) <= 2e-3, (got["map"], want["map"])
    assert got["ap"].keys() == want["ap"].keys()
    for c, ap in want["ap"].items():
        assert abs(got["ap"][c] - ap) <= 1e-2, (category[c], got["ap"][c], ap)
