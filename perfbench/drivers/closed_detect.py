"""Closed loop of batch detect calls: bulk and offline detection.

Each call is ``Inference.detect_fn`` on ``fold``ed params, over the next
``batch`` frames of a seeded pool on the card (the pool is ``pool`` frames,
so consecutive calls take different frames), issued back to back; a
synchronize opens the window and one closes it after the last call, and
``detect_img_per_s`` is the images of every call over that time.  The traced
segment after the window is ``trace_calls`` more calls.  A sample of
``sample_calls`` calls of the window, drawn from the seed, is compared with
the reference once the window has closed.

Traffic keys: ``batch``, ``pool``, ``threshold``, ``overlap``, ``topk``,
``warmup_calls``, ``trace_calls``, ``sample_calls``."""

from __future__ import annotations

import time

from perfbench.harness import compare, faults, inputs, program, shapes
from perfbench.harness.context import Outcome
from perfbench.harness.sample import Reservoir
from perfbench.harness.trace import Segment


def run(ctx) -> Outcome:
    cfg, traffic = ctx.config, ctx.traffic
    size, batch = cfg["size"], traffic["batch"]
    params, state = inputs.make_params(cfg, ctx.seed, ctx.device)
    frames = inputs.make_frames(traffic["pool"], size, ctx.seed, ctx.device)
    ctx.mark("inputs")
    model = program.build_model(cfg)
    detect, folded = program.detect_fn(model, params, state, traffic)
    detect = faults.detect_under(ctx, detect, params, state)
    ctx.mark("program")
    slots = traffic["pool"] // batch
    rows = lambda i: slice((i % slots) * batch, (i % slots) * batch + batch)
    for i in range(traffic["warmup_calls"]):
        detect(folded, frames[rows(i)])
    ctx.sync()
    ctx.mark("warmup")
    ctx.reset_peak()

    sample = Reservoir(traffic["sample_calls"], ctx.seed)
    calls = 0
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    while True:
        out = detect(folded, frames[rows(calls)])
        sample.offer((calls, out))
        calls += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    window_s = time.perf_counter() - t0
    ctx.mark("window")

    record = None
    if ctx.trace:
        before = program.launch_counters()
        with Segment() as seg:
            for i in range(traffic["trace_calls"]):
                detect(folded, frames[rows(calls + i)])
        after = program.launch_counters()
        record = {"segment": seg.record, "segment_s": seg.seconds,
                  "segment_calls": traffic["trace_calls"],
                  "counters": {k: after[k] - before[k] for k in after},
                  "window_s": window_s, "window_images": calls * batch,
                  "forward_flops": shapes.forward_flops(cfg["plan"], size),
                  "kernel_work": shapes.kernel_work(cfg["plan"], size, cfg["pallas"], batch),
                  "routed": {k: len(v) for k, v in
                             shapes.routed_layers(cfg["plan"], size, cfg["pallas"]).items()}}
        ctx.mark("trace")
    peak = ctx.memory_peak()
    del detect, folded, model

    grid = size // 32
    parts = []
    for i, out in sorted(sample.items, key=lambda item: item[0]):
        images = frames[rows(i)]
        ref = compare.reference_detect(cfg, params, state, images, traffic)
        parts.append(compare.detect_numbers(out, ref, grid, traffic["threshold"],
                                            traffic["overlap"]))
    numbers = compare.merge_detect(parts)
    ctx.mark("check")
    return Outcome(end_to_end={"detect_img_per_s": calls * batch / window_s, "setup_s": setup_s},
                   numbers=numbers, attempted=calls * batch, failed=0, memory_peak_bytes=peak,
                   record=record)
