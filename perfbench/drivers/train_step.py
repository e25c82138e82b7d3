"""The train step, looped: fine-tuning on one's own images.

Set-up builds one step (``make_train_step`` with the configuration's model,
SGD with momentum after a global-norm clip, the region loss) and one
state, and drives them through their first ``checked_steps`` steps on the
first batches of a seeded pool (``pool_batches`` batches of ``batch``
images, ``boxes`` boxes each), which warms every shape.  The window then
goes on with the same state and step over the pool's next batches, back
to back; ``train_img_per_s`` is the images of every step over the time from
a synchronize before the first to one after the last.  The traced segment
after the window is ``trace_steps`` more steps.

The check: the reference runs the first ``checked_steps`` steps from the
same initial params on the same batches (``compare.py``).

Traffic keys: ``batch``, ``boxes``, ``pool_batches``, ``lr``, ``momentum``,
``clip``, ``weight_decay``, ``loss_weights``, ``loss``, ``seen``,
``checked_steps``, ``trace_steps``."""

from __future__ import annotations

import time

import torch

from perfbench.harness import compare, faults, inputs, program, shapes
from perfbench.harness.context import Outcome
from perfbench.harness.trace import Segment


def _leaf_norms(tree) -> dict:
    return {(k, n): torch.linalg.vector_norm(v.detach().float())
            for k, lp in tree.items() for n, v in lp.items()}


def run(ctx) -> Outcome:
    cfg, traffic = ctx.config, ctx.traffic
    size, batch, pool = cfg["size"], traffic["batch"], traffic["pool_batches"]
    params0, state = inputs.make_params(cfg, ctx.seed, ctx.device)
    images = inputs.make_frames(pool * batch, size, ctx.seed, ctx.device, tag="train_frames")
    truth = inputs.make_boxes(pool * batch, traffic["boxes"], cfg["num_classes"], ctx.seed,
                              ctx.device)
    batches = [{"images": images[i * batch:(i + 1) * batch],
                **{k: v[i * batch:(i + 1) * batch] for k, v in truth.items()}}
               for i in range(pool)]
    ctx.mark("inputs")
    model = program.build_model(cfg)
    step, optimizer = program.train_step(model, traffic)
    step = faults.step_under(ctx, step)
    ctx.mark("program")
    seen = traffic["seen"]

    params, opt_state = params0, optimizer.init(params0)
    losses, first = [], None
    for i in range(traffic["checked_steps"]):
        params, state, opt_state, m = step(params, state, opt_state, batches[i % pool], seen)
        losses.append(m["total"].detach())
        if first is None:
            first = _leaf_norms(opt_state["trace"])
    change = _leaf_norms({k: {n: params[k][n] - params0[k][n] for n in lp}
                          for k, lp in params.items()})
    ctx.sync()
    prog = {"losses": [float(v) for v in losses],
            "first": {k: float(v) for k, v in first.items()},
            "change": {k: float(v) for k, v in change.items()}}
    ctx.mark("first_steps")
    ctx.reset_peak()

    steps = traffic["checked_steps"]
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    n = 0
    while True:
        params, state, opt_state, m = step(params, state, opt_state, batches[(steps + n) % pool],
                                           seen)
        n += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    last = float(m["total"])
    ctx.sync()
    window_s = time.perf_counter() - t0
    steps += n
    ctx.mark("window")

    record = None
    if ctx.trace:
        with Segment() as seg:
            for i in range(traffic["trace_steps"]):
                params, state, opt_state, m = step(params, state, opt_state,
                                                   batches[(steps + i) % pool], seen)
        record = {"segment": seg.record, "segment_s": seg.seconds,
                  "segment_steps": traffic["trace_steps"],
                  "window_s": window_s, "window_images": n * batch,
                  "forward_flops": shapes.forward_flops(cfg["plan"], size)}
        ctx.mark("trace")
    peak = ctx.memory_peak()
    del params, state, opt_state, m, step, model

    ref_losses, ref_first, ref_params = compare.train_reference(
        cfg, traffic, params0, batches[:traffic["checked_steps"]])
    numbers = compare.train_numbers(prog, ref_losses, ref_first, ref_params, params0)
    ctx.mark("check")
    failed = 0 if torch.isfinite(torch.tensor(last)) else 1
    return Outcome(end_to_end={"train_img_per_s": n * batch / window_s, "setup_s": setup_s},
                   numbers=numbers, attempted=n, failed=failed, memory_peak_bytes=peak,
                   record=record)
