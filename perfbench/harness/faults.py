"""Stand-ins for the timed path, for the calibration of the check's limits
and for the tests that see ``correct`` come out false; a benchmark run uses
none of them.

* ``program="control"``: the reference in the program's place, rounded to
  fp8 e4m3 (``reference/yolo.py::fp8``) at every point where the program
  rounds to bf16, in training also the gradient flowing back through those
  points (``fp8_both``): the precision next below the configurations' bf16;
* ``program="reference_bf16"``: the same with bf16 in place of fp8, which
  follows the program's own rounding, forward and backward (a witness of
  how much of the program's gap its precision explains);
* ``fault="half_batch"``: the first half of each batch goes through the
  program and the rest is left out (detection: nothing kept for it;
  training: the mean over the half);
* ``fault="alter_answer"``: each call's boxes of its first image are moved
  down by half a grid cell where the program produced them;
* ``fault="unchanged_state"``: the train step runs and returns the params,
  BN state and optimizer state it was given."""

from __future__ import annotations

import torch

from ..reference import yolo as R

__all__ = ["detect_under", "step_under", "ROUNDINGS"]


def _bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _bf16_both(t):
    return R.round_both(t, _bf16)


# the stand-ins' roundings: (inference, training)
ROUNDINGS = {"control": (R.fp8, R.fp8_both), "reference_bf16": (_bf16, _bf16_both)}


def _reference_detect(cfg, traffic, params, state, rnd):
    from .compare import reference_detect

    def detect(folded, images):
        _, _, (boxes, conf, keep, _) = reference_detect(cfg, params, state, images, traffic,
                                                        rnd=rnd)
        return boxes[..., :2], boxes[..., 2:], conf, keep
    return detect


def detect_under(ctx, detect, params, state):
    """The detect call a run times: the program's, or a stand-in."""
    if ctx.program in ROUNDINGS:
        return _reference_detect(ctx.config, ctx.traffic, params, state,
                                 ROUNDINGS[ctx.program][0])
    if ctx.fault == "half_batch":
        def half(folded, images):
            n = len(images) // 2
            out = detect(folded, images[:n])
            pad = lambda t: torch.cat([t, torch.zeros((len(images) - n, *t.shape[1:]),
                                                      dtype=t.dtype, device=t.device)])
            return tuple(pad(t) for t in out)
        return half
    if ctx.fault == "alter_answer":
        shift = 0.5 * 32 / ctx.config["size"]

        def altered(folded, images):
            yx_min, yx_max, conf, keep = detect(folded, images)
            yx_min, yx_max = yx_min.clone(), yx_max.clone()
            yx_min[0, ..., 0] += shift
            yx_max[0, ..., 0] += shift
            return yx_min, yx_max, conf, keep
        return altered
    return detect


def _reference_step(cfg, traffic, rnd):
    from .compare import train_step_reference

    def step(params, state, opt_state, batch, seen):
        return train_step_reference(cfg, traffic, params, state, opt_state, batch, seen,
                                    rnd=rnd)
    return step


def step_under(ctx, step):
    """The train step a run times: the program's, or a stand-in."""
    if ctx.program in ROUNDINGS:
        return _reference_step(ctx.config, ctx.traffic, ROUNDINGS[ctx.program][1])
    if ctx.fault == "half_batch":
        def half(params, state, opt_state, batch, seen):
            n = len(batch["images"]) // 2
            return step(params, state, opt_state, {k: v[:n] for k, v in batch.items()}, seen)
        return half
    if ctx.fault == "unchanged_state":
        def unchanged(params, state, opt_state, batch, seen):
            _, _, _, metrics = step(params, state, opt_state, batch, seen)
            return params, state, opt_state, metrics
        return unchanged
    return step
