"""The port's ``eval_ap`` (a copy of ``yolojax/eval_ap.py``) against the
original on seeded recorders: every AP exactly equal.

Each case fills one recorder per package with the same ground truth and
detections, made with numpy from a seed: boxes near a gt (true positives,
duplicates), boxes anywhere (false positives), difficult / crowd gts, a
class with ground truth and no detection, a class with detections and no
ground truth, a class absent from both, repeated ``add_ground_truth`` calls
for one image, and PR curves whose recall lands exactly on the 11-point
thresholds.
"""

import numpy as np
import pytest

import yolojax.eval_ap as jap
import yolojax_torch.eval_ap as tap

NUM_CLASSES = 6


def _fill(rng, recorders, images: int, difficult_frac: float):
    """The same gts and detections into every recorder of ``recorders``."""
    for img in range(images):
        n = int(rng.integers(0, 6))
        lo = rng.uniform(0, 0.7, (n, 2))
        hi = lo + rng.uniform(0.05, 0.3, (n, 2))
        cls = rng.choice([0, 1, 2, 3], n)          # class 4: dets only; 5: nothing
        diff = rng.uniform(size=n) < difficult_frac
        split = n // 2                             # two calls for one image: merged
        for r in recorders:
            r.add_ground_truth(img, lo[:split], hi[:split], cls[:split], diff[:split])
            r.add_ground_truth(img, lo[split:], hi[split:], cls[split:], diff[split:])
        dets = []
        for j in range(n):
            for _ in range(int(rng.integers(0, 3))):   # near the gt: TP or duplicate
                jit = rng.normal(0, 0.02, (2, 2))
                dets.append((lo[j] + jit[0], hi[j] + jit[1], cls[j] if cls[j] != 3 else 1))
        for _ in range(int(rng.integers(0, 4))):       # anywhere, any class but 5
            a = rng.uniform(0, 0.8, 2)
            dets.append((a, a + rng.uniform(0.05, 0.2, 2), int(rng.integers(0, 5))))
        if not dets:
            continue
        dmin = np.asarray([d[0] for d in dets], np.float32)
        dmax = np.asarray([d[1] for d in dets], np.float32)
        dcls = np.asarray([d[2] for d in dets])
        # coarse confidences: ties across images and classes are common
        conf = np.round(rng.uniform(0.005, 1, len(dets)), 2).astype(np.float32)
        for r in recorders:
            r.add_detections(img, dmin, dmax, conf, dcls)


def _curve(rng):
    """A PR curve with recalls on multiples of 1/npos (npos 5: 0.6 == 3/5)."""
    npos = int(rng.integers(1, 8))
    tp = (rng.uniform(size=int(rng.integers(0, 12))) < 0.6).astype(float)
    ctp, cfp = np.cumsum(tp), np.cumsum(1 - tp)
    return ctp / npos, ctp / np.maximum(ctp + cfp, 1e-12)


CASES = ["voc07", "voc_continuous", "voc_iou_0.7", "coco", "coco_max_dets_2", "curves",
         "no_detections"]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", CASES)
def test_eval_ap_equals_the_reference(case, seed):
    rng = np.random.default_rng(seed)
    if case == "curves":
        for _ in range(20):
            recall, precision = _curve(rng)
            for use07 in (True, False):
                assert tap.voc_ap(recall, precision, use07) == jap.voc_ap(recall, precision, use07)
            assert tap.ap_101pt(recall, precision) == jap.ap_101pt(recall, precision)
        return
    got, want = tap.DetectionRecorder(NUM_CLASSES), jap.DetectionRecorder(NUM_CLASSES)
    _fill(rng, [got, want], images=12, difficult_frac=0.15)
    if case == "no_detections":
        got.dets.clear()
        want.dets.clear()
    if case.startswith("coco"):
        kw = {"max_dets": 2} if case == "coco_max_dets_2" else {}
        g, w = tap.evaluate_coco(got, **kw), jap.evaluate_coco(want, **kw)
        assert g == w
        assert set(g["ap"][0.5]) == {0, 1, 2, 3}      # 4 and 5 have no gt: excluded
        plain = lambda dets: {c: [(i, conf, dmin.tolist(), dmax.tolist())
                                  for i, conf, dmin, dmax in rows] for c, rows in dets.items()}
        assert plain(tap._cap_dets_per_image(got.dets, 1)) == \
            plain(jap._cap_dets_per_image(want.dets, 1))
    else:
        iou = 0.7 if case == "voc_iou_0.7" else 0.5
        for use07 in ((False,) if case == "voc_continuous" else (True, False)):
            g = tap.evaluate(got, iou_threshold=iou, use_07_metric=use07)
            w = jap.evaluate(want, iou_threshold=iou, use_07_metric=use07)
            assert g == w
            assert set(g["ap"]) == {0, 1, 2, 3}
    if case == "no_detections":
        assert tap.evaluate(got)["map"] == 0.0
    else:
        assert 0.0 < tap.evaluate(got)["map"] < 1.0
