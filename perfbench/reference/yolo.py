"""Plain float32 YOLOv2, the benchmark's reference.

Everything here is worked out again from the benchmark's own inputs (the
configuration's plan, the seeded parameters, BN state, frames and boxes):
BN folding, the forward with its convs, bias + leaky, max pools, darknet's
passthrough reorg and the concat, the region head's decode, per-class greedy
NMS, the region loss, and SGD with momentum after a global-norm clip.  It
follows darknet's region layer (pjreddie/darknet, ``src/region_layer.c``,
``src/reorg_layer.c``) and the YOLO9000 paper; it imports nothing of the
program under test and nothing of JAX.

``rnd``, where a forward takes it, rounds at the points where a program
that computes in a lower precision rounds: the input, each conv's weights,
each conv's output, BN's batch statistics and ``y − mean`` (training), and
each block's output; the bias, BN's scale and shift and leaky stay f32.
Without it every value is f32.  The check's control passes an fp8 rounding
there (``fp8``; in training ``fp8_both``, which also rounds the gradient
that flows back through each of those points, as a program whose backward
computes in that precision does).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["resolve", "conv_layers", "param_shapes", "fold", "forward", "forward_train",
           "decode", "iou", "nms", "region_loss", "sgd_step", "leaky", "reorg_darknet", "fp8",
           "fp8_both", "round_both", "run", "float32_exact"]

LEAKY_SLOPE = 0.1
FP8_MAX = 448.0            # largest finite float8_e4m3fn


def resolve(plan, in_ch: int = 3) -> list[dict]:
    """The plan's ops with each conv's input channels (``in``) and groups
    filled in; a copy."""
    ch, slots, out = in_ch, {}, []
    for op in plan:
        op = dict(op)
        kind = op["op"]
        if kind == "conv":
            op["in"] = ch
            op["groups"] = ch if op.get("depthwise") else 1
            op.setdefault("stride", 1)
            op.setdefault("bn", True)
            op.setdefault("act", True)
            ch = op["out"]
        elif kind == "mark":
            slots[op["slot"]] = ch
        elif kind == "load":
            ch = slots[op["slot"]]
        elif kind == "reorg":
            ch *= op["stride"] ** 2
        elif kind == "concat":
            ch += slots[op["slot"]]
        out.append(op)
    return out


def conv_layers(plan) -> list[dict]:
    return [op for op in resolve(plan) if op["op"] == "conv"]


def param_shapes(plan) -> dict:
    """{layer: {leaf: shape}}: an OIHW ``w``, then ``gamma`` and ``beta``
    with BN or ``b`` without."""
    shapes = {}
    for op in conv_layers(plan):
        o, k = op["out"], op["k"]
        leaves = {"w": (o, op["in"] // op["groups"], k, k)}
        leaves.update({"gamma": (o,), "beta": (o,)} if op["bn"] else {"b": (o,)})
        shapes[op["name"]] = leaves
    return shapes


def fold(plan, params, state, eps: float) -> dict:
    """{layer: (w, b)} in f32: BN's scale γ/√(σ²+ε) folded into the weights,
    β − μ·scale as the bias."""
    out = {}
    for op in conv_layers(plan):
        p = params[op["name"]]
        w = p["w"].float()
        if op["bn"]:
            s = state[op["name"]]
            scale = p["gamma"].float() / torch.sqrt(s["var"].float() + eps)
            out[op["name"]] = (w * scale[:, None, None, None],
                               p["beta"].float() - s["mean"].float() * scale)
        else:
            out[op["name"]] = (w, p["b"].float())
    return out


def leaky(x):
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def reorg_darknet(x, stride: int):
    """darknet's ``reorg_cpu(x, w, h, c, batch, stride, forward=0, out)`` on an
    NCHW tensor, by its own index formula: output element ``(k, j, i)`` of
    the (C, H, W) buffer is input element ``out_index`` of the same buffer,
    and the result is read as (C·s², H/s, W/s)."""
    b, c, h, w = x.shape
    s = stride
    out_c = c // (s * s)
    k = torch.arange(c, device=x.device)[:, None, None]
    j = torch.arange(h, device=x.device)[None, :, None]
    i = torch.arange(w, device=x.device)[None, None, :]
    c2, offset = k % out_c, k // out_c
    w2 = i * s + offset % s
    h2 = j * s + offset // s
    out_index = (w2 + w * s * (h2 + h * s * c2)).reshape(-1)
    flat = x.reshape(b, -1)
    return flat[:, out_index].reshape(b, c * s * s, h // s, w // s)


def fp8(t):
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude to 448), back in f32."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _RoundBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return fn(t)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


def round_both(t, fn):
    """``fn(t)`` in the forward; in the backward the gradient that flows
    back through this point is rounded by ``fn`` too."""
    return _RoundBoth.apply(t, fn)


def fp8_both(t):
    """:func:`fp8` in the forward and on the gradient in the backward."""
    return round_both(t, fp8)


def _same(t):
    return t


def _conv(x, w, op, rnd):
    return rnd(F.conv2d(rnd(x), rnd(w), stride=op["stride"], padding=op["k"] // 2,
                        groups=op["groups"]))


def run(plan, x, conv_block):
    """The plan over NHWC images ``x``: ``conv_block(op, x)`` runs one conv
    block (the op, with ``in`` and ``groups`` resolved) on NCHW ``x``; the
    pools, the passthrough and the concat are the same for every forward."""
    x = x.permute(0, 3, 1, 2).float()
    slots = {}
    for op in resolve(plan):
        kind = op["op"]
        if kind == "conv":
            x = conv_block(op, x)
        elif kind == "pool":
            if op["stride"] != op["size"]:
                raise ValueError("reference: only VALID pools with stride == size")
            x = F.max_pool2d(x, op["size"], op["stride"])
        elif kind == "mark":
            slots[op["slot"]] = x
        elif kind == "load":
            x = slots[op["slot"]]
        elif kind == "reorg":
            x = reorg_darknet(x.contiguous(), op["stride"])
        elif kind == "concat":
            x = torch.cat([x, slots[op["slot"]]], dim=1)
        else:
            raise ValueError(f"reference: unknown op {kind!r}")
    return x.permute(0, 2, 3, 1)


def forward(plan, folded, images, rnd=None):
    """Folded inference forward: NHWC images in [0, 1] → raw head (B, h, w,
    A·(5+C)) in f32."""
    rnd = rnd or _same

    def block(op, x):
        w, b = folded[op["name"]]
        y = _conv(x, w, op, rnd) + b.view(1, -1, 1, 1)
        return rnd(leaky(y) if op["act"] else y)
    return run(plan, rnd(images.float()), block)


def forward_train(plan, params, images, eps: float, rnd=None):
    """Train-mode forward on unfolded params: BN by the batch's mean and
    biased variance."""
    rnd = rnd or _same

    def block(op, x):
        p = params[op["name"]]
        y = _conv(x, p["w"], op, rnd)
        if op["bn"]:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), correction=0)
            mean, var = rnd(mean), rnd(var)
            y = rnd(y - mean.view(1, -1, 1, 1)) * torch.rsqrt(var + eps).view(1, -1, 1, 1)
            y = y * p["gamma"].view(1, -1, 1, 1) + p["beta"].view(1, -1, 1, 1)
        else:
            y = y + p["b"].view(1, -1, 1, 1)
        return rnd(leaky(y) if op["act"] else y)
    return run(plan, rnd(images.float()), block)


def _split(raw, anchors):
    b, h, w, ch = raw.shape
    a = anchors.shape[0]
    return raw.float().reshape(b, h, w, a, ch // a)


def _boxes(x, anchors):
    """Corners (B, H, W, A, 4) ``[ymin, xmin, ymax, xmax]`` of the head ``x``
    (B, H, W, A, 5+C), normalised to the image."""
    b, h, w, a, _ = x.shape
    dev = x.device
    grid = torch.stack(torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                                      torch.arange(w, device=dev, dtype=torch.float32),
                                      indexing="ij"), dim=-1)[None, :, :, None, :]
    scale = torch.tensor([h, w], dtype=torch.float32, device=dev)
    center = (torch.sigmoid(x[..., 0:2]) + grid) / scale
    size = anchors.to(dev).float() * torch.exp(torch.clamp(x[..., 2:4], -12.0, 12.0)) / scale
    return torch.cat([center - size / 2, center + size / 2], dim=-1)


def decode(raw, anchors):
    """Raw head → (boxes (B, N, 4), conf (B, N, C)), candidates in the order
    ``n = (y·W + x)·A + a``; ``conf = sigmoid(t_o) · softmax(t_cls)``."""
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=raw.device)
    x = _split(raw, anchors)
    b = x.shape[0]
    boxes = _boxes(x, anchors).reshape(b, -1, 4)
    conf = torch.sigmoid(x[..., 4:5]) * torch.softmax(x[..., 5:], dim=-1)
    return boxes, conf.reshape(b, boxes.shape[1], -1)


def _area(box):
    hw = torch.clamp(box[..., 2:4] - box[..., 0:2], min=0.0)
    return hw[..., 0] * hw[..., 1]


def iou(a, b):
    """IoU of broadcastable box sets ``[ymin, xmin, ymax, xmax]``."""
    lo = torch.maximum(a[..., 0:2], b[..., 0:2])
    hi = torch.minimum(a[..., 2:4], b[..., 2:4])
    inter = _area(torch.cat([lo, hi], dim=-1))
    return inter / torch.clamp(_area(a) + _area(b) - inter, min=1e-10)


def nms(boxes, conf, threshold: float, overlap: float, topk: int):
    """Per-class greedy NMS: in each (image, class) the highest remaining
    score is taken while it is ``> threshold`` (the lowest index among equal
    scores), and it suppresses itself and every box of IoU ``> overlap``;
    at most ``topk`` picks.  → (boxes (B, C, K, 4), conf (B, C, K), keep
    (B, C, K), the picks' candidate indices (B, C, K)), picks in score
    order."""
    b, n, c = conf.shape
    s = conf.transpose(1, 2).reshape(b * c, n).clone()
    bx = boxes[:, None].expand(b, c, n, 4).reshape(b * c, n, 4)
    rows = torch.arange(b * c, device=conf.device)
    lane = torch.arange(n, device=conf.device)
    out_box = torch.zeros((b * c, topk, 4), device=conf.device)
    out_conf = torch.zeros((b * c, topk), device=conf.device)
    keep = torch.zeros((b * c, topk), dtype=torch.bool, device=conf.device)
    index = torch.zeros((b * c, topk), dtype=torch.long, device=conf.device)
    for k in range(topk):
        best, i = s.max(dim=1)
        active = best > threshold
        if not bool(active.any()):
            break
        pick = bx[rows, i]
        out_box[:, k] = pick
        out_conf[:, k] = torch.where(active, best, 0.0)
        keep[:, k] = active
        index[:, k] = i
        hit = (iou(pick[:, None], bx) > overlap) | (lane[None] == i[:, None])
        s = torch.where(active[:, None] & hit, -math.inf, s)
    shape = (b, c, topk)
    return (out_box.reshape(*shape, 4), out_conf.reshape(shape), keep.reshape(shape),
            index.reshape(shape))


def region_loss(raw, anchors, yx_min, yx_max, cls, valid, seen: float, cfg: dict) -> dict:
    """darknet's region loss, each term summed over an image's slots and
    averaged over the batch → {coord, object, noobject, cls, prior}.

    Each valid gt box goes to the cell of its centre and that cell's anchor
    of best shape-only IoU (the first of equal ones); of valid gts on one
    slot the last wins.  Positive slots: coordinates in transform space
    weighted by ``2 − w·h``, objectness toward the IoU of the slot's decoded
    box with its gt (no gradient through the target), classes by the squared
    error of the softmax whose gradient is ``prob − truth`` straight onto
    the logits (darknet's delta).  Other slots: objectness toward 0 where
    their box's best IoU with any valid gt is under ``ignore_threshold``;
    while ``seen < warmup_seen``, coordinates toward the anchor prior."""
    b, h, w, ch = raw.shape
    dev = raw.device
    anchors = torch.as_tensor(anchors, dtype=torch.float32, device=dev)
    a = anchors.shape[0]
    c = ch // a - 5
    n = h * w * a
    x = _split(raw, anchors).reshape(b, n, 5 + c)
    yx_min, yx_max, valid = yx_min.float(), yx_max.float(), valid.bool()
    g = yx_min.shape[1]
    scale = torch.tensor([h, w], dtype=torch.float32, device=dev)
    center = (yx_min + yx_max) / 2 * scale
    size = torch.clamp(yx_max - yx_min, min=0.0) * scale
    cell = torch.minimum(torch.clamp(torch.floor(center), min=0.0), scale - 1)
    inter = torch.minimum(size[:, :, None], anchors[None, None]).prod(-1)          # (B, G, A)
    shape_iou = inter / torch.clamp(size.prod(-1)[:, :, None] + anchors.prod(-1) - inter,
                                    min=1e-10)
    best_anchor = torch.argmax(shape_iou, dim=-1)
    slot = ((cell[..., 0] * w + cell[..., 1]) * a + best_anchor).long()            # (B, G)
    later_same = ((slot[:, :, None] == slot[:, None, :])
                  & torch.ones((g, g), dtype=torch.bool, device=dev).triu(1)
                  & valid[:, None, :])
    wins = valid & ~later_same.any(dim=2)

    boxes = _boxes(x.detach().reshape(b, h, w, a, 5 + c), anchors).reshape(b, n, 4)
    gt_box = torch.cat([yx_min, yx_max], dim=-1)                                    # (B, G, 4)
    slot_box = torch.gather(boxes, 1, slot[..., None].expand(-1, -1, 4))
    obj_target = iou(slot_box, gt_box)
    best_iou = (iou(boxes[:, :, None], gt_box[:, None]) * valid[:, None].float()).amax(-1)

    pos = torch.zeros((b, n), device=dev)
    t_yx = torch.zeros((b, n, 2), device=dev)
    t_hw = torch.zeros((b, n, 2), device=dev)
    t_cls = torch.zeros((b, n, c), device=dev)
    t_obj = torch.zeros((b, n), device=dev)
    boost = torch.zeros((b, n), device=dev)
    wh = torch.clamp(yx_max - yx_min, min=0.0)
    # the winners hold distinct slots, so each slot is written once
    bi, gi = torch.nonzero(wins, as_tuple=True)
    s = slot[bi, gi]
    pos[bi, s] = 1.0
    t_yx[bi, s] = (center - cell)[bi, gi]
    t_hw[bi, s] = torch.log(torch.clamp(size[bi, gi], min=1e-8) / anchors[best_anchor[bi, gi]])
    t_cls[bi, s, cls[bi, gi].long()] = 1.0
    t_obj[bi, s] = obj_target[bi, gi]
    boost[bi, s] = 2.0 - wh[bi, gi, 0] * wh[bi, gi, 1]

    sig_yx, hw, sig_o = torch.sigmoid(x[..., 0:2]), x[..., 2:4], torch.sigmoid(x[..., 4])
    prob = torch.softmax(x[..., 5:], dim=-1)
    coord = (pos * boost * (((sig_yx - t_yx) ** 2).sum(-1) + ((hw - t_hw) ** 2).sum(-1))).sum(1)
    obj = (pos * (sig_o - t_obj) ** 2).sum(1)
    delta = (pos[..., None] * (prob - t_cls)).detach()
    surrogate = (x[..., 5:] * delta).sum((1, 2))
    cls_loss = (delta ** 2).sum((1, 2)) + surrogate - surrogate.detach()
    ignore = (best_iou < cfg["ignore_threshold"]) & (pos == 0)
    noobj = (ignore.float() * sig_o ** 2).sum(1)
    warm = float(seen < cfg["warmup_seen"])
    prior = warm * ((1 - pos) * (((sig_yx - 0.5) ** 2).sum(-1) + (hw ** 2).sum(-1))).sum(1)
    terms = {"coord": coord, "object": obj, "noobject": noobj, "cls": cls_loss, "prior": prior}
    return {k: v.mean() for k, v in terms.items()}


def sgd_step(params, grads, trace, lr: float, momentum: float, clip: float,
             weight_decay: float = 0.0):
    """One SGD step → (params, trace, the clipped gradient): the gradient
    scaled to norm ``clip`` where its global norm is not under it, ``+
    weight_decay·w`` on conv weights, the trace ``g + momentum·trace``, then
    ``p − lr·trace``."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for lp in grads.values()
                          for g in lp.values())).float()
    factor = 1.0 if (clip <= 0 or norm < clip) else clip / norm
    clipped = {k: {n: g * factor for n, g in lp.items()} for k, lp in grads.items()}
    new_trace, new_params = {}, {}
    for k, lp in clipped.items():
        new_trace[k], new_params[k] = {}, {}
        for n, g in lp.items():
            u = g + weight_decay * params[k][n] if (n == "w" and weight_decay) else g
            t = u + momentum * trace[k][n] if trace is not None else u
            new_trace[k][n] = t
            new_params[k][n] = params[k][n] - lr * t
    return new_params, new_trace, clipped


class float32_exact:
    """Context: f32 matmuls and convs in full f32 (TF32 off), restored on exit."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
