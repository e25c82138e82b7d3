"""The plain reference (``reference/yolo.py``) agrees with the port at a
small size on the CPU, in f32, where both compute the same function."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench.harness import compare, inputs, program
from perfbench.harness.cell import HERE
from perfbench.reference import yolo as R

SIZE = 96


def f32_config(name):
    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    return dict(cfg, dtype="float32", pallas=[], size=SIZE, objectness_logit=-3.0)


@pytest.mark.parametrize("name", ["darknet19-voc416", "mobilenet-voc416"])
def test_forward_decode_and_nms_agree(name):
    cfg = f32_config(name)
    params, state = inputs.make_params(cfg, 11, "cpu")
    images = inputs.make_frames(2, SIZE, 11, "cpu")
    traffic = {"threshold": 0.005, "overlap": 0.45, "topk": 100}
    model = program.build_model(cfg)
    detect, folded = program.detect_fn(model, params, state, traffic)
    with torch.no_grad():
        raw = model.apply_folded(folded, images)
        ref_raw = R.forward(cfg["plan"], R.fold(cfg["plan"], params, state, cfg["bn_eps"]), images)
    torch.testing.assert_close(raw, ref_raw, rtol=1e-4, atol=1e-4)
    out = detect(folded, images)
    boxes, conf, (r_box, r_conf, r_keep, _) = compare.reference_detect(cfg, params, state, images,
                                                                      traffic)
    assert int(r_keep.sum()) > 0
    torch.testing.assert_close(out.keep, r_keep)
    torch.testing.assert_close(out.conf[r_keep], r_conf[r_keep], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(torch.cat([out.yx_min, out.yx_max], -1)[r_keep], r_box[r_keep],
                               rtol=1e-4, atol=1e-5)
    numbers = compare.merge_detect([compare.detect_numbers(out, (boxes, conf, (
        r_box, r_conf, r_keep, None)), SIZE // 32, 0.005, 0.45)])
    assert numbers["missed_share"] == numbers["extra_share"] == 0.0
    assert numbers["box_gap"] < 1e-4


def test_reorg_follows_darknets_index_formula():
    from yolojax_torch.ops.reorg import reorg_darknet

    x = torch.randn(2, 64, 6, 6)
    got = R.reorg_darknet(x, 2)
    assert torch.equal(got, reorg_darknet(x.permute(0, 2, 3, 1), 2).permute(0, 3, 1, 2))


def test_train_steps_agree():
    cfg = f32_config("darknet19-voc416")
    traffic = json.loads((HERE / "traffic" / "train-b16.json").read_text())
    params0, state = inputs.make_params(cfg, 12, "cpu")
    truth = inputs.make_boxes(4, 6, 20, 12, "cpu")
    images = inputs.make_frames(4, SIZE, 12, "cpu", tag="train_frames")
    batches = [{"images": images[i:i + 2], **{k: v[i:i + 2] for k, v in truth.items()}}
               for i in (0, 2)]
    step, optimizer = program.train_step(program.build_model(cfg), traffic)
    p, s, o = params0, state, optimizer.init(params0)
    losses, first = [], None
    for batch in batches:
        p, s, o, m = step(p, s, o, batch, traffic["seen"])
        losses.append(float(m["total"]))
        first = first or {(k, n): float(v.norm()) for k, lp in o["trace"].items()
                          for n, v in lp.items()}
    change = {(k, n): float((p[k][n] - params0[k][n]).norm()) for k in p for n in p[k]}
    ref = compare.train_reference(cfg, traffic, params0, batches)
    numbers = compare.train_numbers({"losses": losses, "first": first, "change": change}, *ref,
                                    params0)
    assert numbers["loss_gap"] < 1e-4
    assert numbers["grad_gap"] < 2e-3 and numbers["change_gap"] < 2e-3
