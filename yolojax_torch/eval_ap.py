"""VOC- and COCO-protocol average precision — a copy of ``yolojax/eval_ap.py``
(pure numpy; the tests hold the two equal).

Per class: detections sorted by confidence are matched greedily to the
highest-IoU unmatched ground-truth box in their image; IoU ≥ threshold on an
unmatched gt → TP, otherwise FP; *difficult* gts never count — detections
matched to them are ignored entirely (removed from the PR curve), and they
are excluded from the positive count, per the VOCdevkit protocol.

Both VOC variants are provided: VOC2007 11-point interpolation and the
continuous (every-point) integral; ``[eval] metric07`` selects one.  The COCO
protocol (``evaluate_coco``) averages 101-point AP over IoU 0.5:0.95 with
crowd-ignore matching.

This runs on the host: AP accumulation is ragged (a variable number of
detections per image) and off the device path, which is forward + decode +
NMS (``models/inference.py::Inference.detect_fn``).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .ops.iou import np_iou_matrix

__all__ = ["voc_ap", "ap_101pt", "DetectionRecorder", "evaluate",
           "evaluate_coco"]


def voc_ap(recall: np.ndarray, precision: np.ndarray, use_07_metric: bool = True) -> float:
    """AP from a PR curve; 11-point (VOC2007) or continuous interpolation."""
    if recall.size == 0:
        return 0.0
    if use_07_metric:
        ap = 0.0
        # thresholds as i/10, NOT linspace/arange: those yield
        # 0.6000000000000001 etc., silently excluding recalls that equal the
        # threshold exactly (k/npos == 3/5) — caught by the independent
        # cross-validation oracle (tests/test_ap_crossval.py)
        for t in (np.arange(11) / 10.0):
            mask = recall >= t
            ap += (precision[mask].max() if mask.any() else 0.0) / 11.0
        return float(ap)
    # continuous: envelope the precision, integrate over recall steps
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def ap_101pt(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO-style AP: precision envelope sampled at 101 recall points
    (0, 0.01, …, 1.0), as in pycocotools ``COCOeval.accumulate``."""
    if recall.size == 0:
        return 0.0
    mpre = np.maximum.accumulate(precision[::-1])[::-1]
    # precision at the first detection whose recall >= r (envelope value)
    idx = np.searchsorted(recall, np.arange(101) / 100.0, side="left")
    valid = idx < recall.size
    return float(np.where(valid, mpre[np.minimum(idx, recall.size - 1)], 0.0)
                 .sum() / 101.0)


class DetectionRecorder:
    """Accumulates detections and ground truth across the eval split."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        # per class: lists of (image_id, conf, yx_min, yx_max)
        self.dets: dict[int, list] = defaultdict(list)
        # per (image_id, class): gt boxes + difficult flags
        self.gts: dict[tuple, dict] = {}

    def add_ground_truth(self, image_id, yx_min, yx_max, cls, difficult):
        yx_min = np.asarray(yx_min, np.float64).reshape(-1, 2)
        yx_max = np.asarray(yx_max, np.float64).reshape(-1, 2)
        cls = np.asarray(cls).reshape(-1)
        difficult = np.asarray(difficult, bool).reshape(-1)
        for c in np.unique(cls):
            sel = cls == c
            key = (image_id, int(c))
            new = {"yx_min": yx_min[sel], "yx_max": yx_max[sel],
                   "difficult": difficult[sel]}
            old = self.gts.get(key)
            if old is not None:  # merge repeated calls for the same image
                new = {k: np.concatenate([old[k], new[k]]) for k in new}
            self.gts[key] = new

    def add_detections(self, image_id, yx_min, yx_max, conf, cls):
        for i in range(len(conf)):
            self.dets[int(cls[i])].append(
                (image_id, float(conf[i]), np.asarray(yx_min[i]), np.asarray(yx_max[i])))


def _class_ap(dets: list, gts: dict, cls: int, iou_threshold: float,
              use_07_metric: bool) -> float:
    npos = sum((~g["difficult"]).sum() for (_, c), g in gts.items() if c == cls)
    if npos == 0:
        # class absent from the split: excluded from the mean even when
        # false positives exist (matches pycocotools' AP=-1 exclusion; a
        # class with dets but no gts would otherwise deflate mAP to 0)
        return float("nan")
    if not dets:
        return 0.0
    dets = sorted(dets, key=lambda d: -d[1])
    matched: dict = defaultdict(set)
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (img, _conf, dmin, dmax) in enumerate(dets):
        g = gts.get((img, cls))
        if g is None or len(g["difficult"]) == 0:
            fp[i] = 1
            continue
        ious = np_iou_matrix(dmin[None], dmax[None], g["yx_min"], g["yx_max"])[0]
        j = int(ious.argmax())
        if ious[j] >= iou_threshold:
            if g["difficult"][j]:
                continue  # matched a difficult gt: ignore this detection
            if j in matched[img]:
                fp[i] = 1  # duplicate detection of an already-claimed gt
            else:
                tp[i] = 1
                matched[img].add(j)
        else:
            fp[i] = 1
    keep = (tp + fp) > 0  # detections matched to difficult gts were skipped
    tp, fp = tp[keep], fp[keep]
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / max(npos, 1)
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    return voc_ap(recall, precision, use_07_metric)


def evaluate(recorder: DetectionRecorder, iou_threshold: float = 0.5,
             use_07_metric: bool = True) -> dict:
    """Per-class AP + mAP over the accumulated split."""
    aps = {}
    for c in range(recorder.num_classes):
        ap = _class_ap(recorder.dets.get(c, []), recorder.gts, c,
                       iou_threshold, use_07_metric)
        if not np.isnan(ap):
            aps[c] = ap
    mean = float(np.mean(list(aps.values()))) if aps else 0.0
    return {"ap": aps, "map": mean}


def _class_ap_coco(dets: list, gts: dict, cls: int, iou_threshold: float) -> float:
    """COCO-style per-class AP at one IoU threshold.

    Differences from the VOC matcher above (pycocotools ``COCOeval.evaluateImg``):
    a detection matches the highest-IoU *unmatched, non-ignore* gt with
    IoU ≥ threshold (VOC instead takes the global argmax gt and fails if it
    is already claimed); detections left over that overlap an ignore/crowd gt
    (``difficult`` here — the cache maps COCO ``iscrowd`` onto it) at ≥
    threshold are dropped from the PR curve rather than counted FP; crowd
    overlap is intersection / detection-area (pycocotools ``maskUtils.iou``
    with ``iscrowd=1``), not union IoU, so a small detection inside a large
    crowd region is still ignored; AP uses 101-point recall interpolation.
    """
    npos = sum((~g["difficult"]).sum() for (_, c), g in gts.items() if c == cls)
    if npos == 0:
        return float("nan")  # class absent from split: excluded (pycocotools AP=-1)
    if not dets:
        return 0.0
    dets = sorted(dets, key=lambda d: -d[1])
    matched: dict = defaultdict(set)
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, (img, _conf, dmin, dmax) in enumerate(dets):
        g = gts.get((img, cls))
        if g is None or len(g["difficult"]) == 0:
            fp[i] = 1
            continue
        ious = np_iou_matrix(dmin[None], dmax[None], g["yx_min"], g["yx_max"])[0]
        if g["difficult"].any():
            # crowd/ignore gts: overlap = intersection / detection area
            hw = np.maximum(np.minimum(dmax, g["yx_max"]) - np.maximum(dmin, g["yx_min"]), 0.0)
            inter = hw[:, 0] * hw[:, 1]
            darea = max(float(np.prod(np.maximum(dmax - dmin, 0.0))), 1e-12)
            ious = np.where(g["difficult"], inter / darea, ious)
        order = np.argsort(-ious)
        hit = ignore = False
        for j in order:
            if ious[j] < iou_threshold:
                break
            if g["difficult"][j]:
                ignore = True      # crowd/ignore region covers this detection
                continue
            if int(j) in matched[img]:
                continue           # try the next-best gt (COCO semantics)
            tp[i] = 1
            matched[img].add(int(j))
            hit = True
            break
        if not hit and not ignore:
            fp[i] = 1
    keep = (tp + fp) > 0
    tp, fp = tp[keep], fp[keep]
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / max(npos, 1)
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    return ap_101pt(recall, precision)


def _cap_dets_per_image(dets_by_class: dict, max_dets: int) -> dict:
    """pycocotools ``maxDets``: ``COCOeval.evaluateImg`` truncates each
    *(image, category)* detection list to the top-``max_dets`` by confidence
    (with the default ``useCats=1`` the cap is per category, NOT the popular
    "100 per image across classes" reading — that is a detector-side export
    convention, not what the evaluator computes)."""
    keep: dict = {}
    for c, dets in dets_by_class.items():
        per_image: dict = defaultdict(list)
        for d in dets:
            per_image[d[0]].append(d)
        rows_out = []
        for rows in per_image.values():
            rows.sort(key=lambda r: -r[1])
            rows_out.extend(rows[:max_dets])
        keep[c] = rows_out
    return keep


def evaluate_coco(recorder: DetectionRecorder,
                  iou_thresholds=None, max_dets: int = 100) -> dict:
    """COCO protocol: AP averaged over IoU ∈ {0.5, 0.55, …, 0.95} with
    101-point interpolation (BASELINE.md's "COCO test-dev AP@[.5:.95]").
    Detections are capped at ``max_dets`` per (image, class) — pycocotools'
    ``evaluateImg`` truncation, default 100. Returns ``map`` (the headline
    AP), plus ``map_50``/``map_75`` and the per-threshold per-class table."""
    if iou_thresholds is None:
        iou_thresholds = np.arange(10) * 0.05 + 0.5
    dets_by_class = _cap_dets_per_image(recorder.dets, max_dets)
    per_thr = {}
    for thr in iou_thresholds:
        aps = {}
        for c in range(recorder.num_classes):
            ap = _class_ap_coco(dets_by_class.get(c, []), recorder.gts, c,
                                float(thr))
            if not np.isnan(ap):
                aps[c] = ap
        per_thr[round(float(thr), 2)] = aps
    means = {t: (float(np.mean(list(a.values()))) if a else 0.0)
             for t, a in per_thr.items()}
    return {
        "map": float(np.mean(list(means.values()))) if means else 0.0,
        "map_50": means.get(0.5, 0.0),
        "map_75": means.get(0.75, 0.0),
        "ap": per_thr,
    }
