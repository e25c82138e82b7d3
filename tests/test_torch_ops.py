"""Port parity, ops: yolojax_torch.ops against yolojax.ops on the CPU.

Same numpy inputs through both packages.  Tolerances: reorg is a pure
layout op, so exact; decode rtol/atol 1e-6 (elementwise f32, the two
frameworks' exp/sigmoid/softmax may differ in the last ulp); NMS indices and
validity exact, scores rtol 1e-6.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# yolojax.ops re-exports functions under its submodules' names, so the
# modules are taken from importlib
jdecode, jiou, jnms, jpost, jreorg = (importlib.import_module(f"yolojax.ops.{m}") for m in
                                      ("decode", "iou", "nms", "postprocess", "reorg"))
tdecode, tiou, tnms, tpost, treorg = (importlib.import_module(f"yolojax_torch.ops.{m}")
                                      for m in ("decode", "iou", "nms", "postprocess", "reorg"))


def _boxes(rng, shape):
    center = rng.uniform(0.2, 0.8, (*shape, 2)).astype(np.float32)
    half = rng.uniform(0.05, 0.2, (*shape, 2)).astype(np.float32)
    return center - half, center + half


@pytest.mark.parametrize("order,shape,stride", [
    ("darknet", (2, 8, 8, 8), 2),
    ("darknet", (1, 26, 26, 64), 2),     # the YOLOv2 passthrough shape
    ("darknet", (1, 6, 9, 18), 3),
    ("s2d", (2, 8, 8, 6), 2),
    ("s2d", (1, 12, 6, 5), 3),
])
def test_reorg_matches_jax(rng, order, shape, stride):
    x = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(jreorg.reorg(jnp.asarray(x), stride, order))
    got = treorg.reorg(torch.from_numpy(x), stride, order).numpy()
    np.testing.assert_array_equal(got, want)


def test_reorg_darknet_channels_last_input(rng):
    """The engine hands reorg a channels_last tensor; the result must not
    depend on the memory format."""
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = treorg.reorg_darknet(nchw.permute(0, 2, 3, 1), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jreorg.reorg_darknet(jnp.asarray(x), 2)))


def test_reorg_rejects_bad_shapes():
    with pytest.raises(ValueError):
        treorg.reorg(torch.zeros(1, 5, 4, 8), 2, "darknet")
    with pytest.raises(ValueError):
        treorg.reorg(torch.zeros(1, 4, 4, 6), 2, "darknet")
    with pytest.raises(ValueError):
        treorg.reorg(torch.zeros(1, 4, 4, 8), 2, "bogus")


@pytest.mark.parametrize("b,h,w,a,c", [(2, 13, 13, 5, 20), (1, 4, 3, 2, 3), (3, 2, 2, 1, 1)])
def test_decode_matches_jax(rng, b, h, w, a, c):
    anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
    raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 3).astype(np.float32)
    raw[..., 2] = 20.0   # exercises the ±12 exp clamp
    want = jdecode.decode(jnp.asarray(raw), jnp.asarray(anchors))
    got = tdecode.decode(torch.from_numpy(raw), anchors)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("c", [1, 3, 20, 80])
def test_decode_softmax_sums_in_class_order(rng, c):
    """The denominator is added class by class, as the fused kernel and the
    reference's Pallas kernel add it: the same bits as a left-to-right
    float32 sum of torch's own exp(x − max)."""
    x = torch.from_numpy((rng.standard_normal((64, c)) * 3).astype(np.float32))
    e = torch.exp(x - x.amax(-1, keepdim=True)).numpy()
    denom = e[:, 0].copy()
    for q in range(1, c):
        denom = denom + e[:, q]
    got = tdecode.softmax_in_class_order(x).numpy()
    assert np.array_equal(got, e / denom[:, None])
    assert np.array_equal(tdecode.softmax_in_class_order(x[None])[0].numpy(), got)


def test_iou_pairwise_matches_jax(rng):
    a_min, a_max = _boxes(rng, (64,))
    b_min, b_max = _boxes(rng, (64,))
    b_max[:4] = b_min[:4]  # zero-area boxes
    want = np.asarray(jiou.iou_pairwise(a_min, a_max, b_min, b_max))
    got = tiou.iou_pairwise(*map(torch.from_numpy, (a_min, a_max, b_min, b_max))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tiou.area(torch.from_numpy(a_min), torch.from_numpy(a_max)).numpy(),
                               np.asarray(jiou.area(a_min, a_max)), rtol=1e-6)


def _assert_nms_equal(got, want):
    idx, conf, valid = (t.numpy() for t in got)
    widx, wconf, wvalid = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(valid, wvalid)
    np.testing.assert_array_equal(np.where(valid, idx, 0), np.where(wvalid, widx, 0))
    np.testing.assert_allclose(np.where(valid, conf, 0), np.where(wvalid, wconf, 0), rtol=1e-6)


@pytest.mark.parametrize("n,max_out,threshold", [(64, 16, 0.3), (40, 40, 0.0), (7, 3, 0.5)])
def test_nms_select_matches_jax(rng, n, max_out, threshold):
    yx_min, yx_max = _boxes(rng, (n,))
    scores = rng.uniform(0, 1, n).astype(np.float32)
    want = jnms.nms_select(yx_min, yx_max, scores, threshold, 0.45, max_out)
    got = tnms.nms_select(torch.from_numpy(yx_min), torch.from_numpy(yx_max),
                          torch.from_numpy(scores), threshold, 0.45, max_out)
    _assert_nms_equal(got, want)


def test_nms_select_ties_and_degenerate_boxes(rng):
    """Equal scores pick the lowest index; a zero-area pick suppresses itself."""
    n = 12
    yx_min, yx_max = _boxes(rng, (n,))
    yx_max[3] = yx_min[3]
    scores = np.full(n, 0.5, np.float32)
    scores[[2, 9]] = 0.9
    want = jnms.nms_select(yx_min, yx_max, scores, 0.1, 0.45, n)
    got = tnms.nms_select(torch.from_numpy(yx_min), torch.from_numpy(yx_max),
                          torch.from_numpy(scores), 0.1, 0.45, n)
    _assert_nms_equal(got, want)
    assert got[0][0].item() == 2


def test_nms_select_batched_rows_match_jax(rng):
    b, c, n, max_out = 2, 3, 40, 8
    yx_min, yx_max = _boxes(rng, (b, c, n))
    scores = rng.uniform(0, 1, (b, c, n)).astype(np.float32)
    got = tnms.nms_select(torch.from_numpy(yx_min), torch.from_numpy(yx_max),
                          torch.from_numpy(scores), 0.3, 0.45, max_out)
    assert got[0].shape == (b, c, max_out)
    for bi in range(b):
        for ci in range(c):
            want = jnms.nms_select(yx_min[bi, ci], yx_max[bi, ci], scores[bi, ci],
                                   0.3, 0.45, max_out)
            _assert_nms_equal([t[bi, ci] for t in got], want)


@pytest.mark.parametrize("threshold,topk", [(0.05, 10), (0.6, 4)])
def test_postprocess_matches_jax(rng, threshold, topk):
    b, n, c = 2, 45, 5
    yx_min, yx_max = _boxes(rng, (b, n))
    conf = rng.uniform(0, 1, (b, n, c)).astype(np.float32) ** 3
    iou = rng.uniform(0, 1, (b, n)).astype(np.float32)
    want = jpost.postprocess(jdecode.Detections(*map(jnp.asarray, (yx_min, yx_max, iou, conf,
                                                                   conf))),
                             threshold, 0.45, topk)
    got = tpost.postprocess(tdecode.Detections(*map(torch.from_numpy, (yx_min, yx_max, iou,
                                                                       conf, conf))),
                            threshold, 0.45, topk)
    keep = np.asarray(want.keep)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(np.where(keep, got.conf.numpy(), 0),
                               np.where(keep, np.asarray(want.conf), 0), rtol=1e-6)
    for name in ("yx_min", "yx_max"):
        np.testing.assert_array_equal(np.where(keep[..., None], getattr(got, name).numpy(), 0),
                                      np.where(keep[..., None], np.asarray(getattr(want, name)), 0))
