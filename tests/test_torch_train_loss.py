"""Port parity, region loss: ``yolojax_torch.ops.loss.region_loss`` against
``yolojax.ops.loss.region_loss`` on the same numpy inputs (f32, CPU).

Each case compares the five per-component batch means and the gradient of
the weighted total with respect to the raw head, ``jax.value_and_grad``
against autograd.  Tolerance: rtol 1e-5 on the components, and on the
gradient rtol 1e-5 with atol 1e-6 of its largest magnitude (elements that
are near zero).  Also the new IoU helpers against ``yolojax.ops.iou``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.ops import iou as jiou
from yolojax.ops.loss import LossConfig as JaxLossConfig
from yolojax.ops.loss import region_loss as jax_region_loss
from yolojax_torch.ops import iou as tiou
from yolojax_torch.ops.loss import LossConfig, region_loss

WEIGHTS = {"coord": 1.0, "object": 5.0, "noobject": 1.0, "cls": 1.0, "prior": 0.01}


def make_inputs(seed, b=2, h=5, w=4, a=3, c=4, g=6, invalid=0.2):
    rng = np.random.default_rng(seed)
    raw = rng.normal(0, 1.5, (b, h, w, a * (5 + c))).astype(np.float32)
    anchors = rng.uniform(0.5, 3.0, (a, 2)).astype(np.float32)
    center = rng.uniform(0.1, 0.9, (b, g, 2))
    size = rng.uniform(0.05, 0.5, (b, g, 2))
    yx_min = np.clip(center - size / 2, 0, 1).astype(np.float32)
    yx_max = np.clip(center + size / 2, 0, 1).astype(np.float32)
    cls = rng.integers(0, c, (b, g)).astype(np.int32)
    valid = rng.uniform(size=(b, g)) >= invalid
    return raw, anchors, yx_min, yx_max, cls, valid


def jax_loss(inputs, seen, cfg):
    raw, anchors, yx_min, yx_max, cls, valid = inputs

    def total(r):
        comps = jax_region_loss(r, jnp.asarray(anchors), yx_min, yx_max, cls, valid, seen, cfg)
        return sum(WEIGHTS[k] * comps[k] for k in comps), comps

    (_, comps), grad = jax.value_and_grad(total, has_aux=True)(jnp.asarray(raw))
    return {k: float(v) for k, v in comps.items()}, np.asarray(grad)


def port_loss(inputs, seen, cfg):
    raw, anchors, yx_min, yx_max, cls, valid = (torch.from_numpy(np.asarray(v)) for v in inputs)
    raw = raw.clone().requires_grad_(True)
    comps = region_loss(raw, anchors, yx_min, yx_max, cls, valid, seen, cfg)
    sum(WEIGHTS[k] * comps[k] for k in comps).backward()
    return {k: v.item() for k, v in comps.items()}, raw.grad.numpy()


def check(inputs, seen=float("inf"), **cfg):
    want, want_grad = jax_loss(inputs, seen, JaxLossConfig(**cfg))
    got, got_grad = port_loss(inputs, seen, LossConfig(**cfg))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5,
                               atol=1e-6 * max(np.abs(want_grad).max(), 1e-6))
    return got, got_grad


@pytest.mark.parametrize("rescore", [True, False], ids=["rescore", "no-rescore"])
@pytest.mark.parametrize("coord_boost", [True, False], ids=["boost", "no-boost"])
@pytest.mark.parametrize("class_grad", ["darknet", "mse"])
def test_loss_and_grad_match(rescore, coord_boost, class_grad):
    got, _ = check(make_inputs(1), rescore=rescore, coord_boost=coord_boost,
                   class_grad=class_grad)
    assert all(v > 0 for k, v in got.items() if k != "prior")


@pytest.mark.parametrize("seen", [0, 12799, 12800, 1e9])
def test_warmup_prior_gated_on_seen(seen):
    got, _ = check(make_inputs(2), seen=seen)
    assert (got["prior"] > 0) == (seen < 12800)


def test_two_gts_on_one_slot_last_wins():
    raw, anchors, yx_min, yx_max, cls, valid = make_inputs(3, c=5)
    yx_min[0, 2], yx_max[0, 2] = yx_min[0, 1], yx_max[0, 1]
    cls[0, 1], cls[0, 2] = 0, 3
    valid[0, 1:3] = True
    inputs = (raw, anchors, yx_min, yx_max, cls, valid)
    got, _ = check(inputs)
    # the later gt's class is the one trained: its one-hot moves the loss
    cls_first = cls.copy()
    cls_first[0, 2] = 0
    changed, _ = port_loss((raw, anchors, yx_min, yx_max, cls_first, valid), float("inf"),
                           LossConfig())
    assert changed["cls"] != got["cls"]


def test_all_invalid_batch():
    raw, anchors, yx_min, yx_max, cls, valid = make_inputs(4)
    got, grad = check((raw, anchors, yx_min, yx_max, cls, np.zeros_like(valid)), seen=0)
    assert got["coord"] == got["object"] == got["cls"] == 0.0
    assert got["noobject"] > 0 and got["prior"] > 0 and np.isfinite(grad).all()


def test_one_class():
    check(make_inputs(5, c=1), seen=100)


def test_coco_classes():
    check(make_inputs(6, b=2, h=3, w=3, a=5, c=80, g=10))


def test_iou_helpers_match(rng):
    a_min = rng.uniform(0, 0.6, (2, 5, 2)).astype(np.float32)
    a_max = a_min + rng.uniform(0, 0.4, (2, 5, 2)).astype(np.float32)
    b_min = rng.uniform(0, 0.6, (2, 3, 2)).astype(np.float32)
    b_max = b_min + rng.uniform(-0.1, 0.4, (2, 3, 2)).astype(np.float32)
    t = lambda *xs: [torch.from_numpy(x) for x in xs]
    for name in ("intersection", "iou_matrix"):
        want = np.asarray(getattr(jiou, name)(a_min, a_max, b_min, b_max))
        got = getattr(tiou, name)(*t(a_min, a_max, b_min, b_max)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=name)
    hw1, hw2 = a_max - a_min, (b_max - b_min)[0]
    np.testing.assert_allclose(tiou.wh_iou_matrix(*t(hw1, hw2)).numpy(),
                               np.asarray(jiou.wh_iou_matrix(hw1, hw2)), rtol=1e-6, atol=1e-7)
