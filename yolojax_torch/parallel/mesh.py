"""The train step — counterpart of ``yolojax/parallel/mesh.py``.

    [augment] → forward (train-mode BN) → region loss → gradients → update

The JAX package jits this into one program per input size and shards it
over a data mesh, where GSPMD makes the BN statistics, the gradients and the
loss the global batch's.  Here it is eager autograd, on one device or on one
rank of a ``torch.distributed`` process group (``group``), each rank with
its share of the global batch:

* the BN statistics are summed over the group (``blocks.conv_apply``);
* the gradients are averaged over the group before ``Optimizer.step``, so
  the clip and ``grad_norm`` see the global gradient;
* the loss components and ``total`` are averaged over the group, as the JAX
  step's are global-batch means;

so every rank ends the step with the same params, BN state and optimizer
state.  The mesh functions map to the group: ``make_mesh`` /
``make_mesh_for_batch`` to the group torchrun starts (its world size is
fixed at launch, ``collectives.init_from_env``), ``shard_host_batch`` /
``batch_sharding`` to :func:`batch_slice`, and ``replicated_sharding`` to
every rank holding the whole params.  Compiled or graph-captured steps per
bucketed size are not ported.

A step runs under the span ``yolojax_torch.train_step`` (``utils/trace.py``;
recorded only while a profiler records), its phases under
``yolojax_torch.train.augment`` (with an augmentation), ``.forward``,
``.loss``, ``.backward`` (the gradients and the zero fill), ``.allreduce``
(with a group) and ``.optimizer`` (the update and the metrics' norm).
"""

from __future__ import annotations

import torch

from ..ops.loss import LossConfig, region_loss
from ..utils.trace import span
from ..utils.train import Optimizer, global_norm
from .collectives import average, average_grads, rank, world

__all__ = ["make_train_step", "loss_weights_from_config", "batch_slice"]


def batch_slice(global_batch: dict, group) -> dict:
    """This rank's rows ``[rank·b, (rank+1)·b)`` of every leading axis, ``b``
    the global batch over the world size: the rows the JAX package's
    ``batch_sharding`` hands this process.  The dict itself with no group."""
    if group is None:
        return global_batch
    n, r = world(group), rank(group)
    out = {}
    for k, v in global_batch.items():
        if len(v) % n:
            raise ValueError(f"batch_slice: {k} has {len(v)} rows, not a multiple of {n} ranks")
        b = len(v) // n
        out[k] = v[r * b:(r + 1) * b]
    return out


def loss_weights_from_config(config) -> dict[str, float]:
    get = lambda k, d: config.getfloat("loss", k, fallback=d)
    return {"coord": get("coord", 1.0), "object": get("object", 5.0),
            "noobject": get("noobject", 1.0), "cls": get("cls", 1.0),
            "prior": get("prior", 0.01)}


def make_train_step(model, optimizer: Optimizer, weights: dict[str, float],
                    loss_cfg: LossConfig, augment=None, group=None):
    """Build the train step.

    Without ``augment``:
        step(params, state, opt_state, batch, seen)
    with ``batch`` = {images (B,S,S,3) in [0, 1], yx_min, yx_max, cls, valid}.

    With ``augment`` (a ``TrainAugment``):
        step(params, state, opt_state, batch, seen, draws, out_size)
    with ``batch`` = {canvas (B,C,C,3) u8, hw, yx_min, yx_max, cls, valid} and
    ``draws`` from ``augment.draw``.

    Returns (params, state, opt_state, metrics): ``metrics`` holds the five
    loss components, ``total``, ``grad_norm`` (the global norm of the
    gradients before any clipping) and ``grads``, all detached.  ``seen``
    (images seen so far) drives the loss warmup.  Nothing given is modified.

    With ``group``, ``batch`` and ``draws`` are this rank's share
    (:func:`batch_slice`), and the metrics, gradients and statistics are the
    global batch's (see the module docstring).
    """
    anchors_on = {}

    def _update(params, state, opt_state, images, yx_min, yx_max, cls, valid, seen):
        dev = images.device
        if dev not in anchors_on:
            anchors_on[dev] = torch.as_tensor(model.anchors, dtype=torch.float32, device=dev)
        leaves = [(k, n) for k, lp in params.items() for n in lp]
        with span("yolojax_torch.train.forward"):
            live = {k: {n: v.detach().requires_grad_(True) for n, v in lp.items()}
                    for k, lp in params.items()}
            raw, new_state = model.apply(live, state, images, train=True, group=group)
        with span("yolojax_torch.train.loss"):
            comps = region_loss(raw, anchors_on[dev], yx_min, yx_max, cls, valid, seen, loss_cfg)
            total = sum(weights[k] * comps[k] for k in comps)
        with span("yolojax_torch.train.backward"):
            got = torch.autograd.grad(total, [live[k][n] for k, n in leaves], allow_unused=True)
            grads = {k: {} for k in params}
            for (k, n), g in zip(leaves, got):
                # a leaf the forward did not read (γ or β switched off) gets 0
                grads[k][n] = torch.zeros_like(params[k][n]) if g is None else g
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in comps.items()}
            metrics["total"] = total.detach()
            if group is not None:
                with span("yolojax_torch.train.allreduce"):
                    grads = average_grads(grads, group)
                    metrics = average(metrics, group)
            with span("yolojax_torch.train.optimizer"):
                new_params, new_opt_state = optimizer.step(grads, opt_state, params)
                metrics.update(grad_norm=global_norm(grads), grads=grads)
        return new_params, new_state, new_opt_state, metrics

    if augment is None:
        def step(params, state, opt_state, batch, seen):
            images = batch["images"]
            with span("yolojax_torch.train_step", cuda=images.is_cuda, images=images.shape[0]):
                return _update(params, state, opt_state, images, batch["yx_min"],
                               batch["yx_max"], batch["cls"], batch["valid"], seen)
    else:
        def step(params, state, opt_state, batch, seen, draws, out_size: int):
            canvas = batch["canvas"]
            with span("yolojax_torch.train_step", cuda=canvas.is_cuda, images=canvas.shape[0]):
                with span("yolojax_torch.train.augment"):
                    images, ymin, ymax, valid = augment.apply(
                        canvas, batch["hw"], batch["yx_min"], batch["yx_max"], batch["valid"],
                        draws, out_size)
                return _update(params, state, opt_state, images, ymin, ymax, batch["cls"],
                               valid, seen)
    return step
