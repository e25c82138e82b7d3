"""Open loop of fixed-rate camera streams, batched on one card.

``cameras`` cameras send a frame every ``1/fps`` seconds each, their phases
spread evenly over the frame period and dealt to the cameras in an order
drawn from the seed (so every seed offers the same arrivals, and the seed
picks which camera, and so which frames, sends when); a frame is due at its
own time, whatever the server is doing.  The server batches as DeepStream's
stream muxer (``nvstreammux``) does, with its ``batch-size`` and
``batched-push-timeout``: once ``batch`` frames not yet taken are due, or
the oldest of them has waited ``timeout_s``, it takes up to ``batch`` of
them, pads a short batch with copies of its last frame to the next multiple
of ``pad_to`` (their outputs are discarded), makes one
``Inference.detect_fn`` call on it and synchronizes; every padded shape up
to ``batch`` is warmed in set-up.  ``batch`` is a number, or ``"cameras"``:
one frame of each source a batch, as DeepStream advises.  Frames come from
a seeded pool of ``pool`` frames on the card.  A frame's latency is the
time the call that held it returned from its synchronize, less the time the
frame was due.  Frames due in the ``lead_in_s`` before the window are
served but not counted; every frame due in the window is counted, and the
loop runs until the last of them is served.  ``stream_p95_ms`` is the 95th
percentile of those latencies.

The traced segment after the window is a second open loop of the same
cameras, ``trace_s`` seconds after a lead-in of its own.  A sample of
``sample_calls`` calls of the window, drawn from the seed, and the call
with the largest batch are compared with the reference (their real frames).

Traffic keys: ``cameras``, ``fps``, ``batch``, ``timeout_s``, ``pad_to``, ``pool``,
``lead_in_s``, ``trace_s``, ``drain_limit_s``, ``threshold``, ``overlap``,
``topk``, ``sample_calls``."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from perfbench.harness import compare, faults, inputs, program
from perfbench.harness.context import Outcome
from perfbench.harness.sample import Reservoir
from perfbench.harness.trace import Segment


def batch_size(traffic: dict) -> int:
    """The muxer's ``batch-size``: the traffic's ``batch``, where
    ``"cameras"`` is the number of sources."""
    return traffic["cameras"] if traffic["batch"] == "cameras" else traffic["batch"]


def padded_shapes(traffic: dict) -> range:
    """Every batch size a call can have once padded to ``pad_to``."""
    pad = traffic["pad_to"]
    return range(pad, -(-batch_size(traffic) // pad) * pad + 1, pad)


def schedule(traffic: dict, seed: int, seconds: float):
    """(due times, pool rows) of every frame from the start of the lead-in to
    the end of the window, in time order: camera ``i`` sends at ``phase_i +
    j/fps``, the phases ``k/cameras`` of a period dealt out by the seed, and
    its frame ``j`` is pool row ``(i·frames_per_camera + j) % pool``."""
    rng = np.random.default_rng(inputs.sub_seed(seed, "cameras"))
    n, period = traffic["cameras"], 1.0 / traffic["fps"]
    phases = period * rng.permutation(n) / n
    end = traffic["lead_in_s"] + seconds
    per = int(math.ceil(end / period)) + 1
    due = (phases[:, None] + period * np.arange(per)[None, :]).ravel()
    rows = np.arange(n * per) % traffic["pool"]
    order = np.argsort(due, kind="stable")
    due, rows = due[order], rows[order]
    return due[due < end], rows[due < end]


def serve(ctx, detect, folded, frames, due, rows, window_start: float, calls_out=None):
    """Serve the frames of ``due`` (seconds from now; pool rows ``rows``) →
    (completion time of each frame or NaN where it was never served, per-call
    host issue ms and real frames of the calls that started in the window).
    ``calls_out`` gets (first frame, frames, output) of each such call."""
    traffic = ctx.traffic
    pad, cap, timeout = traffic["pad_to"], batch_size(traffic), traffic["timeout_s"]
    rows = torch.as_tensor(rows, device=frames.device)
    done = np.full(len(due), np.nan)
    issue_ms, batches = [], []
    arange = torch.arange(-(-cap // pad) * pad, device=frames.device)
    t0 = time.perf_counter()
    limit = due[-1] + traffic["drain_limit_s"]
    p = 0
    while p < len(due):
        now = time.perf_counter() - t0
        if now > limit:
            break
        ready = int(np.searchsorted(due, now, side="right"))
        # a call goes once a full batch is due or the oldest frame timed out
        go = due[min(p + cap, len(due)) - 1] if p + cap <= len(due) else math.inf
        go = min(go, due[p] + timeout)
        if ready == p or now < go:
            time.sleep(max(0.0, min(go - now, 0.001)))
            continue
        take = min(ready - p, cap)
        padded = -(-take // pad) * pad
        index = rows[torch.clamp(arange[:padded], max=take - 1) + p]
        start = time.perf_counter()
        out = detect(folded, frames.index_select(0, index))
        issued = time.perf_counter()
        ctx.sync()
        done[p:p + take] = time.perf_counter() - t0
        if due[p] >= window_start:
            issue_ms.append((issued - start) * 1e3)
            batches.append(take)
            if calls_out is not None:
                calls_out((p, take, out))
        p += take
    return done, issue_ms, batches


def run(ctx) -> Outcome:
    cfg, traffic = ctx.config, ctx.traffic
    params, state = inputs.make_params(cfg, ctx.seed, ctx.device)
    frames = inputs.make_frames(traffic["pool"], cfg["size"], ctx.seed, ctx.device)
    ctx.mark("inputs")
    model = program.build_model(cfg)
    detect, folded = program.detect_fn(model, params, state, traffic)
    detect = faults.detect_under(ctx, detect, params, state)
    ctx.mark("program")
    for b in padded_shapes(traffic):
        detect(folded, frames[:b])
    ctx.sync()
    ctx.mark("warmup")
    ctx.reset_peak()

    lead = traffic["lead_in_s"]
    due, rows = schedule(traffic, ctx.seed, ctx.seconds)
    sample = Reservoir(traffic["sample_calls"], ctx.seed)
    largest = []

    def keep(call):
        sample.offer(call)
        if not largest or call[1] > largest[0][1]:
            largest[:] = [call]

    setup_s = time.perf_counter() - ctx.t_process
    done, issue_ms, batches = serve(ctx, detect, folded, frames, due, rows, lead, keep)
    counted = due >= lead
    served = counted & np.isfinite(done)
    latency_ms = (done[served] - due[served]) * 1e3
    p95 = float(np.percentile(latency_ms, 95)) if len(latency_ms) else math.inf
    ctx.mark("window")

    record = None
    if ctx.trace:
        t_due, t_rows = schedule(traffic, ctx.seed + 1, traffic["trace_s"])
        with Segment() as seg:
            _, _, t_batches = serve(ctx, detect, folded, frames, t_due, t_rows, lead)
        record = {"segment": seg.record, "segment_s": seg.seconds,
                  "host_issue_ms": issue_ms, "batches": batches,
                  "segment_batches": t_batches, "p95_ms": p95}
        ctx.mark("trace")
    peak = ctx.memory_peak()
    del detect, folded, model

    calls = {c[0]: c for c in sample.items + largest}
    grid = cfg["size"] // 32
    parts = []
    for p, take, out in (calls[k] for k in sorted(calls)):
        index = torch.as_tensor(rows[p:p + take], device=frames.device)
        ref = compare.reference_detect(cfg, params, state, frames.index_select(0, index), traffic)
        parts.append(compare.detect_numbers(tuple(t[:take] for t in out), ref, grid,
                                            traffic["threshold"],
                                            traffic["overlap"]))
    numbers = compare.merge_detect(parts)
    ctx.mark("check")
    numbers["calls_compared"] = len(parts)
    numbers["largest_batch"] = max(batches) if batches else 0
    return Outcome(end_to_end={"stream_p95_ms": p95, "setup_s": setup_s}, numbers=numbers,
                   attempted=int(counted.sum()), failed=int((counted & ~served).sum()),
                   memory_peak_bytes=peak, record=record)
