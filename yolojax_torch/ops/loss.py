"""YOLOv2 region loss — counterpart of ``yolojax/ops/loss.py``, batched over
the images directly instead of vmapped.

The semantics are the JAX package's (darknet's region layer):

1. **Assignment** — each gt box goes to the grid cell of its center and, in
   that cell, to the anchor of largest shape-only IoU.  When two valid gts
   land on one (cell, anchor) slot the later one wins (darknet's sequential
   overwrite).
2. **Positive terms** on the matched slots: coordinates in transform space
   with the ``(2 − w·h)`` small-box boost, objectness toward IoU(pred, gt)
   ("rescore", the IoU carried without gradient) or 1, and the class term.
3. **Negative term** — objectness toward 0 on slots whose best IoU against
   any valid gt is under the ignore threshold.
4. **Warmup term** — while ``seen < warmup_seen``, unmatched slots are pulled
   toward their anchor priors.

The JAX package scatters the per-gt targets onto the slots with a one-hot
matmul at HIGHEST precision.  Here they are scattered by index: winners are
unique per slot, so each slot receives one target, exactly, in f32.  Losers
and padded gts write into one spare slot past the end, which is dropped, so
the scatter needs no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .decode import decode
from .iou import iou_matrix, iou_pairwise, wh_iou_matrix

__all__ = ["region_loss", "LossConfig"]


class LossConfig(NamedTuple):
    """Loss hyperparameters (from the ``[loss]`` config section).

    ``class_grad``: the class term's VALUE is the squared error of the softmax
    probabilities either way; ``"darknet"`` gives it darknet's gradient
    ``prob − truth`` on the logits (no softmax Jacobian), ``"mse"`` the true
    MSE gradient through the softmax.
    """

    ignore_threshold: float = 0.6
    rescore: bool = True
    coord_boost: bool = True
    warmup_seen: int = 12800
    class_grad: str = "darknet"


def region_loss(raw, anchors, gt_yx_min, gt_yx_max, gt_cls, gt_valid, seen=float("inf"),
                cfg: LossConfig = LossConfig()) -> dict:
    """Batched region loss → dict of per-component means over the batch.

    raw: (B, H, W, A*(5+C)); anchors: (A, 2) (h, w) in grid units; gt_*:
    (B, G, ...) padded, with the ``gt_valid`` mask; ``seen``: the number of
    images seen so far, which turns the warmup term on or off.
    """
    b, h, w, ch = raw.shape
    dev = raw.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    a = anchors.shape[0]
    per = ch // a
    c = per - 5
    n = h * w * a
    g = gt_yx_min.shape[1]
    f32 = torch.float32
    gt_yx_min, gt_yx_max = gt_yx_min.to(f32), gt_yx_max.to(f32)
    gt_valid = gt_valid.to(torch.bool)

    x = raw.to(f32).reshape(b, n, per)
    sig_yx = torch.sigmoid(x[..., :2])          # (B, N, 2)
    t_hw = x[..., 2:4]                          # (B, N, 2) raw log-space
    sig_o = torch.sigmoid(x[..., 4])            # (B, N)
    prob = torch.softmax(x[..., 5:], dim=-1)    # (B, N, C)

    scale = torch.tensor([h, w], dtype=f32, device=dev)
    gt_center = (gt_yx_min + gt_yx_max) * 0.5 * scale         # grid units
    gt_hw = torch.clamp(gt_yx_max - gt_yx_min, min=0.0) * scale
    cell = torch.minimum(torch.clamp(torch.floor(gt_center), min=0.0), scale - 1)  # (B, G, 2)

    # best anchor by shape-only IoU (argmax: the first of equal maxima)
    anchor_idx = torch.argmax(wh_iou_matrix(gt_hw, anchors), dim=-1)               # (B, G)
    flat_idx = ((cell[..., 0] * w + cell[..., 1]) * a + anchor_idx).long()         # (B, G)

    # last wins: a gt loses if a later valid gt maps to the same slot
    same = flat_idx[:, :, None] == flat_idx[:, None, :]
    later = torch.ones((g, g), dtype=torch.bool, device=dev).triu(1)
    beaten = (same & later & gt_valid[:, None, :]).any(dim=2)
    winner = gt_valid & ~beaten                                                    # (B, G)
    slot = torch.where(winner, flat_idx, n)     # losers write into the spare slot n

    def scatter(v):
        """(B, G, D) per-gt values → (B, N, D) on the winners' slots, 0 elsewhere."""
        out = torch.zeros((b, n + 1, v.shape[-1]), dtype=f32, device=dev)
        out.scatter_(1, slot[..., None].expand(-1, -1, v.shape[-1]), v.to(f32))
        return out[:, :n]

    # per-gt targets in transform space
    tyx_target = gt_center - cell
    anchor_hw = anchors[anchor_idx]                                                # (B, G, 2)
    thw_target = torch.log(torch.clamp(gt_hw, min=1e-8) / anchor_hw)
    cls_target = (gt_cls.long()[..., None] == torch.arange(c, device=dev)).to(f32)  # (B, G, C)
    hw_norm = torch.clamp(gt_yx_max - gt_yx_min, min=0.0)
    boost = (2.0 - hw_norm[..., 0] * hw_norm[..., 1] if cfg.coord_boost
             else torch.ones((b, g), dtype=f32, device=dev))

    # decoded predictions, for the rescore target and the ignore band: both
    # are carried without gradient
    with torch.no_grad():
        det = decode(raw.detach(), anchors)
        p_min, p_max = det.yx_min, det.yx_max                                      # (B, N, 2)
        index = flat_idx[..., None].expand(-1, -1, 2)
        iou_target = iou_pairwise(torch.gather(p_min, 1, index), torch.gather(p_max, 1, index),
                                  gt_yx_min, gt_yx_max)                            # (B, G)
        full_iou = iou_matrix(p_min, p_max, gt_yx_min, gt_yx_max)                  # (B, N, G)
        best_iou = torch.amax(full_iou * gt_valid[:, None, :].to(f32), dim=-1)     # (B, N)
    obj_target = iou_target if cfg.rescore else torch.ones((b, g), dtype=f32, device=dev)

    targets = scatter(torch.cat([tyx_target, thw_target, cls_target, obj_target[..., None],
                                 boost[..., None], torch.ones_like(boost)[..., None]], dim=-1))
    tyx_t, thw_t, cls_t = targets[..., :2], targets[..., 2:4], targets[..., 4:4 + c]
    obj_t, boost_t, pos_f = targets[..., 4 + c], targets[..., 5 + c], targets[..., 6 + c]
    positive = pos_f > 0

    # positive terms
    coord = torch.sum(pos_f * boost_t * (torch.sum((sig_yx - tyx_t) ** 2, dim=-1)
                                         + torch.sum((t_hw - thw_t) ** 2, dim=-1)), dim=1)
    obj = torch.sum(pos_f * (sig_o - obj_t) ** 2, dim=1)
    if cfg.class_grad == "darknet":
        # value: the squared error of the probabilities; gradient: the delta
        # ``prob − truth`` straight onto the logits (the surrogate term)
        delta = (pos_f[..., None] * (prob - cls_t)).detach()
        surrogate = torch.sum(x[..., 5:] * delta, dim=(1, 2))
        cls_loss = torch.sum(delta ** 2, dim=(1, 2)) + surrogate - surrogate.detach()
    else:
        cls_loss = torch.sum(pos_f[..., None] * (prob - cls_t) ** 2, dim=(1, 2))

    # negatives: best IoU of each predicted box against any valid gt
    noobj_mask = (best_iou < cfg.ignore_threshold) & ~positive
    noobj = torch.sum(noobj_mask.to(f32) * sig_o ** 2, dim=1)

    # warmup prior matching on unmatched slots
    warm = float(seen < cfg.warmup_seen)
    neg_f = 1.0 - pos_f
    prior = warm * torch.sum(neg_f * (torch.sum((sig_yx - 0.5) ** 2, dim=-1)
                                      + torch.sum(t_hw ** 2, dim=-1)), dim=1)

    per_image = {"coord": coord, "object": obj, "noobject": noobj, "cls": cls_loss,
                 "prior": prior}
    return {k: v.mean() for k, v in per_image.items()}
