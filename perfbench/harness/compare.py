"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/yolo.py``), worked out again from
the benchmark's own inputs once the window has closed.

Detection (the detect and stream cells).  For each sampled call the
reference folds the seeded params, runs the f32 forward over the same frames
(in blocks of rows), decodes, and runs its own per-class greedy NMS.  Each
box the program kept is matched to the reference candidate of its image
nearest to it (by centre and log size); that candidate is its identity.

* ``conf_gap``: the widest gap between a kept box's score and its
  candidate's reference score in its class, over the larger of that score
  and the threshold; ``conf_gap_median`` and ``conf_gap_p99``: the median
  and the 99th percentile of that gap over every kept box of the compared
  calls (a score scaled by a few % moves both; one pick on a steep softmax
  moves only the widest);
* ``box_gap``: the widest difference of a kept box from its candidate, of
  centre in grid cells or of log size;
* ``missed_share``: the share of the reference's picks that no box the
  program kept in their image and class overlaps by more than the NMS
  overlap;
* ``extra_share``: the same of the program's picks against the
  reference's.

Training.  The reference runs the same three steps from the same initial
params on the same rows.  Per leaf, the gap between the program's norm and
the reference's, over the larger of the reference's norm of that leaf and
that of the median leaf; the worst leaf counts:

* ``grad_gap``: of the first step's gradient as the optimizer holds it
  (SGD's trace after one step: the clipped gradient);
* ``change_gap``: of each leaf's change after three steps;

and the relative gap of each step's total loss (``loss_gap``, the widest).
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of both norms' gaps (none is, on these configurations).

What a training cell compares are the steadier forms: the mean of the
steps' loss gaps (``loss_gap_mean``) and the median leaf's gaps
(``grad_gap_median``, ``change_gap_median``); the widest forms are noise of
one step or one leaf in bf16 (the limits' files give the readings)."""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from ..reference import yolo as R

__all__ = ["reference_detect", "detect_numbers", "merge_detect", "reference_step",
           "train_step_reference", "train_reference", "train_numbers", "judge"]

DETECT_BLOCK = 32          # reference rows per forward
MATCH_BLOCK = 16           # images per block of the nearest-candidate search
SMALL_LEAF = 1e-3


def reference_detect(cfg, params, state, images, traffic, rnd=None):
    """The reference's candidates and picks for NHWC ``images``: (boxes (B, N,
    4), conf (B, N, C), nms → boxes, conf, keep, index)."""
    with R.float32_exact(), torch.no_grad():
        folded = R.fold(cfg["plan"], params, state, cfg["bn_eps"])
        boxes, conf = [], []
        for i in range(0, len(images), DETECT_BLOCK):
            raw = R.forward(cfg["plan"], folded, images[i:i + DETECT_BLOCK], rnd)
            b, c = R.decode(raw, cfg["anchors"])
            boxes.append(b)
            conf.append(c)
        boxes, conf = torch.cat(boxes), torch.cat(conf)
        picks = R.nms(boxes, conf, traffic["threshold"], traffic["overlap"], traffic["topk"])
    return boxes, conf, picks


def _shape(box, grid: int):
    """[centre y, centre x] in grid cells and [log h, log w] of corner boxes."""
    hw = torch.clamp(box[..., 2:4] - box[..., 0:2], min=1e-12)
    return torch.cat([(box[..., 0:2] + box[..., 2:4]) / 2 * grid, torch.log(hw)], dim=-1)


def _nearest(prog_boxes, cand, grid: int):
    """For (B, M, 4) program boxes and (B, N, 4) candidates: the index of each
    box's nearest candidate of its image and the distance to it, the largest
    difference of centre (in cells) or log size."""
    p_all, q_all = _shape(prog_boxes, grid), _shape(cand, grid)
    idx, dist = [], []
    for i in range(0, len(cand), MATCH_BLOCK):
        p, q = p_all[i:i + MATCH_BLOCK], q_all[i:i + MATCH_BLOCK]
        d = (p[:, :, None, :] - q[:, None, :, :]).abs().amax(-1)            # (b, M, N)
        best, at = d.min(-1)
        idx.append(at)
        dist.append(best)
    return torch.cat(idx), torch.cat(dist)


def _covered(a_box, a_keep, b_box, b_keep, overlap: float):
    """For picks ``a`` and ``b`` (B, C, K, ·) of the same images and classes:
    which kept picks of ``a`` have a kept pick of ``b`` in their image and
    class with IoU above ``overlap`` (the one that took or would take its
    place in greedy NMS)."""
    out = []
    for i in range(0, len(a_box), MATCH_BLOCK):
        iou = R.iou(a_box[i:i + MATCH_BLOCK, :, :, None], b_box[i:i + MATCH_BLOCK, :, None])
        hit = (iou > overlap) & b_keep[i:i + MATCH_BLOCK, :, None, :]
        out.append(hit.any(-1) & a_keep[i:i + MATCH_BLOCK])
    return torch.cat(out)


def detect_numbers(out, ref, grid: int, threshold: float, overlap: float) -> dict:
    """Compare one call's program output ``out`` (yx_min, yx_max, conf, keep;
    (B, C, K, ...)) with the reference's ``ref`` (:func:`reference_detect`
    over the same frames) → the call's part of :func:`merge_detect`.

    Each kept program box is matched to its nearest reference candidate
    (centre in cells and log size: the candidate it decodes); its score is
    compared with that candidate's.  A pick of either side counts as found
    where the other side kept a box of its image and class with IoU above
    the NMS overlap: greedy NMS keeps one box of such a pair, and which one
    turns on their scores' order."""
    boxes, conf, (r_box, _, r_keep, _) = ref
    yx_min, yx_max, p_conf, p_keep = (t.float() if t.dtype != torch.bool else t for t in out)
    b, c, k = p_conf.shape
    p_box = torch.cat([yx_min, yx_max], dim=-1)
    at, dist = _nearest(p_box.reshape(b, c * k, 4), boxes, grid)
    at, dist = at.reshape(b, c, k), dist.reshape(b, c, k)
    cls = torch.arange(c, device=at.device)[None, :, None].expand(b, c, k)
    r_conf = conf[torch.arange(b, device=at.device)[:, None, None], at, cls]
    keep, r_keep = p_keep.bool(), r_keep.bool()
    n_prog, n_ref = int(keep.sum()), int(r_keep.sum())
    gap = (p_conf - r_conf).abs() / torch.clamp(r_conf, min=threshold)
    return {"conf_gap": float(gap[keep].max()) if n_prog else 0.0,
            "conf_gaps": gap[keep].float().cpu().numpy(),
            "box_gap": float(dist[keep].max()) if n_prog else 0.0,
            "ref_picks": n_ref, "prog_picks": n_prog,
            "ref_found": int(_covered(r_box, r_keep, p_box, keep, overlap).sum()),
            "prog_found": int(_covered(p_box, keep, r_box, r_keep, overlap).sum())}


def merge_detect(parts: list[dict]) -> dict:
    """The widest gaps, the score gap's median and 99th percentile over every
    kept box, and the shares over every compared call."""
    ref = sum(p["ref_picks"] for p in parts)
    prog = sum(p["prog_picks"] for p in parts)
    gaps = np.concatenate([p["conf_gaps"] for p in parts])
    median, p99 = np.quantile(gaps, [0.5, 0.99]) if len(gaps) else (0.0, 0.0)
    return {"conf_gap": max(p["conf_gap"] for p in parts),
            "conf_gap_median": float(median), "conf_gap_p99": float(p99),
            "box_gap": max(p["box_gap"] for p in parts),
            "missed_share": 1 - sum(p["ref_found"] for p in parts) / ref if ref else 0.0,
            "extra_share": 1 - sum(p["prog_found"] for p in parts) / prog if prog else 0.0,
            "ref_picks": ref, "prog_picks": prog}


def reference_step(cfg, traffic, params, trace, batch, rnd=None):
    """One reference train step → (params, SGD's trace, total loss)."""
    weights = traffic["loss_weights"]
    with R.float32_exact():
        live = {k: {n: v.detach().float().clone().requires_grad_(True) for n, v in lp.items()}
                for k, lp in params.items()}
        raw = R.forward_train(cfg["plan"], live, batch["images"], cfg["bn_eps"], rnd)
        terms = R.region_loss(raw, torch.as_tensor(cfg["anchors"], dtype=torch.float32),
                              batch["yx_min"], batch["yx_max"], batch["cls"], batch["valid"],
                              traffic["seen"], traffic["loss"])
        total = sum(weights[k] * terms[k] for k in terms)
        leaves = [(k, n) for k, lp in live.items() for n in lp]
        got = torch.autograd.grad(total, [live[k][n] for k, n in leaves])
        grads = {k: {} for k in live}
        for (k, n), g in zip(leaves, got):
            grads[k][n] = g
        with torch.no_grad():
            new, trace, _ = R.sgd_step({k: {n: v.detach() for n, v in lp.items()}
                                        for k, lp in live.items()}, grads, trace, traffic["lr"],
                                       traffic["momentum"], traffic["clip"],
                                       traffic["weight_decay"])
    return new, trace, total.detach()


def train_step_reference(cfg, traffic, params, state, opt_state, batch, seen, rnd=None):
    """:func:`reference_step` behind the program's step signature (the
    control); ``seen`` is the traffic's."""
    trace = opt_state["trace"] if opt_state["count"] else None
    new, trace, total = reference_step(cfg, traffic, params, trace, batch, rnd)
    return new, state, {"count": opt_state["count"] + 1, "trace": trace}, {"total": total}


def train_reference(cfg, traffic, params, batches):
    """The reference's steps from ``params`` on ``batches`` → (total loss of
    each step, SGD's trace after the first step, the params after the
    last)."""
    trace, losses, first = None, [], None
    for batch in batches:
        params, trace, total = reference_step(cfg, traffic, params, trace, batch)
        losses.append(float(total))
        if first is None:
            first = trace
    return losses, first, params


def _norms(tree):
    return {(k, n): float(torch.linalg.vector_norm(v.float())) for k, lp in tree.items()
            for n, v in lp.items()}


def train_numbers(prog: dict, ref_losses, ref_first, ref_params, params0) -> dict:
    """``prog``: the program's step losses, its per-leaf norms of SGD's trace
    after the first step (``first``) and of the change after the checked
    steps (``change``), keyed (layer, leaf).  Besides the compared numbers,
    each step's loss gap, the median leaf's gaps and the worst leaves."""
    r_first = _norms(ref_first)
    r_change = _norms({k: {n: ref_params[k][n] - params0[k][n].float() for n in lp}
                       for k, lp in ref_params.items()})
    median_grad = statistics.median(r_first.values())
    counted = [key for key, v in r_first.items() if v >= SMALL_LEAF * median_grad]

    def gaps(p, r):
        floor = statistics.median(r[key] for key in counted)
        return {key: abs(p[key] - r[key]) / max(r[key], floor) for key in counted}

    loss_gaps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                 for a, b in zip(prog["losses"], ref_losses)]
    first, change = gaps(prog["first"], r_first), gaps(prog["change"], r_change)
    worst = lambda g: max(g, key=g.get)
    return {"loss_gap_mean": sum(loss_gaps) / len(loss_gaps), "loss_gap": max(loss_gaps),
            "grad_gap": max(first.values()),
            "change_gap": max(change.values()), "loss_gaps": loss_gaps,
            "grad_gap_median": statistics.median(first.values()),
            "change_gap_median": statistics.median(change.values()),
            "grad_worst": "/".join(worst(first)), "change_worst": "/".join(worst(change)),
            "leaves_counted": len(counted), "leaves": len(r_first)}


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): every number that has a limit must
    be finite and at most it; a cell with no limits is not correct."""
    rows = [(name, numbers[name], limit) for name, limit in limits.items()]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
