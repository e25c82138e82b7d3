#!/usr/bin/env python
"""Smoke run of the PyTorch / CUDA port (``yolojax_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase below
    python3 chip_smoke.py --profile [PATH]    # device, build, then a torch.profiler
                                              # breakdown of PATH's detect at batch 128
                                              # (mobilenet, darknet-s2d, tiny or darknet;
                                              # mobilenet by default)
    python3 chip_smoke.py --node-rank SPEC    # one rank of phase 17, under torchrun
    python3 chip_smoke.py --bench-launches    # tools/bench.py's main, its launches on stderr
    python3 chip_smoke.py --calibrate         # the readings behind phase 14's and phase
                                              # 17 (a)'s bounds (one JSON line; no check)
    python3 chip_smoke.py --tree              # device, then phase 18 alone (one JSON line
                                              # and its kernels row)

Phases, each of which passes or raises (any failure exits non-zero):

1. device — a CUDA device must be present; prints its name and
   ``nvidia-smi``'s name and power limit;
2. build — compiles the seven kernels of ``yolojax_torch/csrc`` at once, one
   ``nvcc`` each, prints each one's registers and spills, and requires
   HGMMA (wgmma) in the SASS of dwsep's bf16 kernel (``cuobjdump``);
   then the host time of one ``maxpool2x2`` call at Tiny's batch-8 pool4
   shape, part by part (``time.perf_counter_ns``, median of 7 rounds of 300
   calls), beside ``F.max_pool2d``, and of one fused decode+NMS call;
3. kernels against their plain versions on the card:
   * fused decode+NMS — raw heads from numpy seeds, f32 and bf16, four
     geometries at topk 100 and, at eval's point (batch 16, topk 300), VOC
     and COCO at 416 and 608, bench and saturated densities: ``keep`` and
     pick order identical (every kept slot the plain pick's box), conf rtol
     1e-5 (2e-5 at C=80), corners atol 1e-5; prints the longest compacted
     row (candidates above the threshold) per case; then a CUDA graph
     capture of one call at each point must hold one node, the fused kernel;
   * dwconv3x3 and dwsep — MobileNet-416's routed shapes at batch 8, an odd
     spatial size, channel counts that are not multiples of 128 (and, for
     dwsep, C = 36: element loads), a last pixel tile that is not full
     (3, 13, 13, 1024) and batch 128, f32 and bf16, stride 1 and 2: f32
     rtol/atol 1e-4 (the JAX tests' bound), bf16
     rtol/atol 1e-2 (about one bf16 ulp: the plain version sums in cuDNN's
     order); prints the share of output elements that are not bit-identical;
     dwconv3x3 must be bit-identical to its tap-order reference
     (``dwconv3x3_taps``, separate torch ops on the card), also where a row
     tile is cut by the image border (37 rows) and where a row takes two
     column tiles;
   * nms_select — the four geometries' decoded heads, bench and saturated
     densities, boxes broadcast over the classes and one box row per class,
     max_out 100 (and 300 at 19×19): idx, conf and valid identical; then the
     postprocess with its gather against the plain one;
   * maxpool2x2 and reorg_s2d — the routed pool shapes at batch 8
     (Darknet-19's and Tiny's conv → pool pairs at 416, from the route), c21's
     (8,26,26,64) with the (8,13,13,1024) top, C = 3, 36 and 72, tails of 5
     to 16 channels and 2×2 inputs, f32 and bf16, inputs with NaN, ±inf and
     signed zeros: the bare kernels and their fused modes (the conv's bias +
     leaky, the pool's full-resolution output, the reorg's concat)
     bit-identical to their plain versions;
4. the ``cuda`` tests — ``pytest -m cuda --noconftest`` over
   ``tests/test_torch_cuda_*.py`` in a child process: every test passes,
   none skips;
5. Darknet main path — full-width Darknet-19 at 416, VOC classes and anchors,
   bf16, built from ``config.ini`` with a seeded fresh init (objectness bias
   −6, the bench density), through ``Inference.detect_fn(0.005, 0.45, 100)``
   on batches of 8; every launch counter is set to 0 just before and read
   just after, and must show per batch the launches the engine's route and
   the post step give (``Inference.launches``: one fused launch, a
   ``maxpool2x2`` for each conv → pool pair with its conv's epilogue, the
   one-pass epilogue ``bias_leaky_nhwc`` for every other conv) and nothing
   else;
   the outputs must be finite and ``keep`` must match the plain postprocess
   of the same raw head; every epilogue call of one forward, on the conv
   output it is handed, bit-identical to ``bias_leaky`` (six torch ops) on
   the same tensor; the raw head bit-identical to the same forward with
   ``bias_leaky`` in place of the kernel and ``maxpool2x2_plain`` in place of
   the pool kernel (the plain path), in f32 (TF32 off) and, where cuDNN
   allows, in bf16, as for Darknet-s2d; then
   ``cli.detect.detect_image`` on one seeded 480×640 image;
6. MobileNet main path — full-width MobileNet-YOLOv2 at 416 from
   ``config.ini`` + ``config/mobilenet.ini`` with ``pallas = nms fusedpost
   dwsep dwconv``, the same seeded init, density and checks (its route's
   launches: dwconv3x3 and dwsep on the routed depthwise layers); one more batch
   with the objectness bias at 0, where the random head has picks, against
   the plain postprocess; the raw head against the plain path, the same
   forward without ``dwsep dwconv`` (cuDNN) and with ``bias_leaky`` in place
   of the one-pass epilogue: f32 rtol/atol 1e-3 with TF32 off, bf16 mean abs
   diff ≤ 1 % of mean |raw|; then ``detect_image``;
7. Darknet-s2d main path — Darknet-19 from ``config.ini`` with ``reorg =
   s2d`` and ``pallas = nms pool reorg``, the same init, density and
   checks (its route's launches: nms_select and the s2d reorg kernel with
   c21's epilogue and the concat); the dense batch; the raw head bit-identical to the
   plain path (without ``pool reorg``, ``bias_leaky`` for the epilogues,
   ``maxpool2x2_plain`` for the conv → pool pairs) in
   f32 (TF32 off) and, where cuDNN allows, in bf16 (else within MobileNet's
   1 % bound, said so); a CUDA graph capture of one forward: the route's
   pools and reorg run their fused (bias) instantiations, and the
   device kernels per forward with the path's kernels and on the plain
   path; ``torch.profiler``'s host ops: no ``aten::cat``; then
   ``detect_image``;
8. Tiny main path — Tiny-YOLO-VOC from ``config.ini`` + ``config/tiny.ini``
   with ``pallas = nms fusedpost pool``: its route's launches, a
   (B,13,13,125) raw head, the dense batch, the raw head against the plain
   path (without ``pool``) as for Darknet-s2d, ``detect_image``;
9. times (each model's right after its path) — CUDA events, warm-up, median
   of 7 (or of 8 taken in turns): each kernel against its plain version and,
   where one PyTorch call computes the TPU kernel's function, that call
   (``F.conv2d`` with groups for dwconv3x3, ``F.max_pool2d`` on the
   epilogue output), at batch 8 and 128 (fused and nms_select on Darknet's
   raw and decoded heads, each routed depthwise shape, each routed pool as
   the path runs it, on its conv's raw output, the fused reorg + concat at
   c21's shape), each beside its bound (bytes over 3.35 TB/s or operations
   over the peak of their type, from this run's inputs; dwsep's layers also
   as TFLOP/s), and detect images/s of each path and of its plain path
   (without its forward kernels, ``bias_leaky`` for the one-pass
   epilogue, ``maxpool2x2_plain`` for the conv → pool pairs), and each
   routed pool's device µs at batch 128 in a CUDA graph of 20 back-to-back
   calls beside its bytes bound; the one-pass epilogue at c1's and c20's
   shapes and on YOLO9000's padded head (the first 28 269 of 28 272
   channels at 17×17) against
   ``bias_leaky`` (six torch ops; the outputs bit-identical), and a call's
   device µs in a CUDA graph of back-to-back calls, which at batch 128 must
   reach 80 % (c1), 75 % (the head) and 65 % (c20) of 3.35 TB/s;
10. train path — the train CLI's loop (``cli.train.Train``) on 64 seeded
   in-memory images of 200-500 px (filled rectangles; an injected
   ``imread``, as the chip machine has no cv2) through the record cache,
   the threaded loader, the overlapped copies and the fused augmentation:
   full-width Darknet-19 from ``config.ini`` (VOC, bf16, batch 16, canvas
   672, 60 boxes) with the gradient clipped at 5 and the multi-scale size
   redrawn every 4 steps, 12 steps at three sizes, then ``-r`` for 2 more;
   every loss component finite, every parameter and c1's BN state changed,
   the optimizer count right; the final npz through ``load_weights_auto`` →
   ``fold`` → ``detect_fn``, with the fused decode+NMS launch counted as on
   the detect paths; one step at 160², B=2, card against CPU in f32 and f64
   (TF32 off); the step's median time and images/s at 416 in bf16 for B=16
   and B=64 on a device-resident batch and for B=16 through the loader,
   peak memory, the step's parts timed alone and its device time by kernel
   class (``torch.profiler``).  Prints ``{"train": {...}}``;
11. eval path — 48 seeded images (filled rectangles, one box in ten
   difficult) written in VOC2007's layout as binary PPM, and their ``test``
   cache built by the port's ``data/cache.py::cache`` through ``[cache]
   datasets = yolojax.data.voc``; ``cli.eval.run_eval`` on the card on the
   train phase's checkpoint: full-width Darknet-19, 416, bf16, batch 16,
   ``config.ini``'s ``[eval]`` (threshold 0.005, topk 300), every launch
   counter set to 0 just before and read just after: 3 fused decode+NMS
   launches and nothing else; mAP, each class's AP and images/s printed;
   the fused kernel against its plain version on the checkpoint's raw head
   (f32 and bf16, topk 300); the same eval with ``pallas = nms``: 3
   nms_select launches, the same picks slot by slot and the same mAP; the
   eval in f32 on the card and on the CPU (TF32 off): mAP within 2e-3 and
   each class's AP within 1e-2; ``python -m yolojax_torch.cli.eval`` in a child
   process with ``-f`` a ``.weights`` file that ``tools/darknet.py::
   save_weights`` wrote from the same checkpoint: the npz run's mAP exactly,
   the ``mAP =`` line, a ``--results`` jsonl and one ``eval.jsonl`` row (a
   stand-in ``cv2`` that reads PPM goes on the child's path where OpenCV is
   not installed; the in-process runs read through it too); the fused
   kernel's one-call and device times at eval's point beside its bound and
   its plain version.  Prints ``{"eval": {...}}``;
12. deploy and tools — the native host NMS built with g++ (a build failure
   fails the phase); on the train phase's checkpoint ``detect_fn_host``
   (forward on the card, NMS on the host) against ``detect_fn`` (the fused
   kernel) on 3 batches of 8 at ``[detect]``'s point and at 0.005: ``keep``,
   pick order, conf and corners bit for bit; BASELINE config 1:
   ``detect_image`` with the model and image on the CPU in f32 (the host
   path) against the card's, the same classes and boxes within 1e-4, and
   the CPU path's time for one image; ``cli/export.py::export_program`` of
   the four paths at 416, B=8, saved, with the custom-op calls each routes
   (MobileNet dwconv 4, dwsep 7; Darknet pool 5; Darknet-s2d pool 5, reorg
   1; Tiny pool 5),
   replayed in one child process (``import yolojax_torch.kernels.ops``,
   ``torch.export.load``) bit-identical to the eager forward + decode, with
   those launches counted; the ONNX export of Darknet's card weights passes
   ``check_model`` and equals the CPU's byte for byte; ``cli/prune.py`` at
   0.3 on the checkpoint, rebuilt with ``model/channels``, ``detect_fn``
   with one fused launch a batch; a seeded Darknet-s2d with spread γ,
   pruned, with ``pool reorg`` bit-identical in f32 to the forward without,
   with the launches the routing gives at the pruned widths;
   ``receptive_field`` of Darknet-19 at 416 in f32, card against CPU (the
   same support box, effective RF within 1e-3 relative); ``plan_to_dot`` of
   the four paths; ``demo_graph``'s export dump of Darknet-s2d;
   ``demo_data``'s samples from the train cache; ``entry()`` on the card.
   Prints ``{"deploy": {...}}``;
13. data-parallel — two ranks in one gloo group on ``cuda:0``
   (``parallel/collectives.py::run_ranks``; NCCL refuses two ranks on one
   card, gloo sums the card's tensors through the host), each a process
   that drives the entry points a user calls: (a) ``cli.train.Train`` for 3
   steps at 160², B=2 a rank, f32, TF32 off, the device-resident dataset,
   against ``Train`` in this process at B=4 on the same global batches:
   components and ``grad_norm`` rtol 1e-4 at step 1 and 1e-3 after, the
   params' change, momentum and BN state within ``DIST_PARITY``, the ranks'
   params, state and momentum bit-identical; (b) Darknet-19 from
   ``config.ini`` at 416, bf16, B=8 a rank, 4 steps through the loader's
   shards: every loss finite, every parameter changed, rank 0's checkpoint
   through ``load_weights_auto`` → ``fold`` → ``detect_fn`` with one fused
   launch a batch, the step time a rank (information: two processes share
   the card); (c) ``[data] device_dataset = 1``: the ranks' batches,
   concatenated, equal one process's device batches and its loader's, bit
   for bit; (d) ``cli.eval.run_eval`` across the ranks on phase 11's cache
   and phase 10's checkpoint, f32, TF32 off: mAP within 1e-4 of phase 11's
   one-process f32 card eval and each class's AP within 1e-3, every
   launch counter set to 0 just before and read just after on each rank: 3
   fused launches a rank and nothing else; the bf16 mAP beside it; (e)
   ``entry.dryrun_multichip(2, device="cuda", backend="gloo")``'s OK line.
   The train CLI's ``--batch`` is the node's, split over its ranks: (a)
   and (c) pass 4, (b) 16.  (a) and its one-process runs use deterministic
   cuDNN.  Prints ``{"dist": {...}}`` and the phase's wall time;
14. the accuracy gate's chain — ``python -m yolojax_torch.tools.synth_gate``'s
   ``main`` in this process at full width (Darknet-19, VOC, multi-scale
   320–608, bf16, the device-resident dataset), cut to 100 images and 300
   steps, into a scratch artifact: every stage exits 0, the grid holds 8
   finite mAPs, the COCO block is there, the criteria are
   ``criteria_for("darknet")``, and with every launch counter set to 0
   just before and read just after, one fused launch per eval batch of the
   grid (3 a cell) and one nms_select launch per batch of the ``pallas =
   nms`` eval; the gate's ``pass`` is printed, not required (300 steps
   train no detector).  Then ``tests/test_convergence.py``'s learning
   check on the card: Tiny overfits 6 images at 64² in 1200 steps (no
   augmentation, lr 3e-3, f32, cuDNN's default algorithms) and must reach mAP@0.3
   = 1.0.  Prints
   ``{"gate": {...}}`` and the phase's wall time;
15. the prune gate's chain — ``python -m yolojax_torch.tools.prune_gate``'s
   ``main`` in this process at full width (Darknet-19, VOC, 416, bf16),
   ``--fresh``, cut to 100 images, 200 source steps and 100 finetune steps:
   every stage exits 0, ``channels_kept`` lies below the dense model's count
   over the same layers, and with every launch counter set to 0 just before
   and read just after, one fused launch per eval batch on the dense,
   pruned and finetuned evals and nothing else; then the pruned
   checkpoint's raw head on 16 eval images through the fused kernel against
   its plain version at eval's point (topk 300, f32 and bf16).  The gate's
   ``pass`` is printed, not required.  Prints ``{"prune_gate": {...}}`` and
   the phase's wall time;
16. the bench — ``python -m yolojax_torch.tools.bench``'s ``main`` in this
   process with its stdout captured, BENCH_ITERS=5, under twelve
   environments: ``infer`` at B=128 for Darknet-19 at 416, 320 and 608, Tiny
   and MobileNet at 416, Darknet-19 with ``BENCH_PALLAS=nms``, MobileNet
   with ``nms,fusedpost,dwconv,dwsep``; ``latency``; ``train`` at B=16;
   ``e2e`` at B=16 through the loader and the device dataset and
   ``pipeline``, where OpenCV imports (where it does not, these runs must
   refuse naming cv2, and the phase says they did not run).  Each prints
   one JSON line with ``bench.py``'s metric name, a finite positive value, its unit,
   ``vs_baseline`` and the card's name and power limit, and with every
   launch counter set to 0 just before and read just after launches what
   its model's route and post step give (``Inference.launches``) once per
   detect call; train, e2e and pipeline none.  The latency run again in 3 processes of its own
   (B=1 is host-bound and reads the host's state).  Then ``python -m
   yolojax_torch.tools.sustained_bench`` for 10 s: one fused launch per
   call, p5 ≤ p50 ≤ p95.  Prints ``{"bench": {...}}`` and the phase's wall
   time.  The rates are BENCH_ITERS=5 readings, not measurements.
17. the last entry points — (a) ``python -m torch.distributed.run --nnodes 2
   --nproc-per-node 1 --node-rank {0,1}`` of ``chip_smoke.py --node-rank``:
   two nodes of one rank each on ``cuda:0``, each rank with torchrun's
   environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE=2``,
   ``LOCAL_WORLD_SIZE=1``, ``GROUP_RANK``), starting the gloo group itself
   (NCCL refuses two ranks on one card) before it calls the CLIs' ``main``:
   the train CLI for 3 steps of Darknet-19 at 416, B=8 a rank, from the
   device-resident dataset on phase 11's 48 images, in bf16 (config.ini's
   recipe: every loss finite, ``step`` and ``seen``, no kernel launched)
   and in f32 (TF32 off, deterministic cuDNN, phase 13 (a)'s sgd: rank 0's
   checkpoint against ``Train`` in this process at the global batch of 16
   within ``DIST_PARITY``, whose readings ``--calibrate`` gives: config.ini's
   recipe in f32 and f64, and two planted faults), then the eval CLI on the
   bf16 checkpoint split
   over the two, with one fused decode+NMS launch a batch on each rank;
   (b) ``python -m yolojax_torch.tools.c80_fusedpost``'s ``main`` at B=64,
   3 calls a route: its JSON line with the card, one postprocess_fused a
   fused call and one nms_select a separate call (the wrappers' counts, and
   a CUDA graph capture of one fused call and of the separate route's post
   stage); then both kernels at that shape against their plain versions on
   a dense head (the weights' own objectness: ~475 000 boxes kept): the
   fused kernel against ``postprocess_raw`` (phase 3's bounds), nms_select
   identical to ``ops/nms.py``'s and ``postprocess_nms`` against
   ``postprocess``; (c) ``python -m yolojax_torch.tools.bench_all --only LATENCY
   TINY`` at BENCH_ITERS=5, each job's bench run as ``chip_smoke.py
   --bench-launches`` (the bench counting its own launches into the
   artifact's diagnostics): one artifact a job with the card, one fused
   launch a detect call.  Prints ``{"nodes": {...}}`` and the phase's wall
   time.

18. YOLO9000 and the WordTree kernels — ``kernels/tree.py::tree_decode``
   (``csrc/tree_decode.cu``: the walk and the per-node NMS, built here at
   first use), threshold 0.005, overlap 0.45, topk 100: (a) the main path:
   ``config.ini`` + ``config/yolo9000.ini`` (``flagship("yolo9000")``: c1-c18
   and the 28 269-wide linear head, 544, bf16, random weights with the
   head's class rows ×8 so walks go a few groups deep and objectness bias
   -2.5) through ``Inference.detect_fn`` at B=8, 8 and 128, every launch
   counter set to 0 just before: per call its route's ``maxpool2x2`` and
   ``bias_leaky_nhwc`` and 2 ``tree_decode`` (the walk, the NMS); each
   call's picks held to
   ``ops/tree.py::tree_postprocess`` on the raw head it decoded, its raw
   head to the plain path's (``raw_vs_without``), then ``detect_image``;
   (b) the kernels alone on seeded heads (17×17×3 boxes of 5 + 9 418
   channels, bf16: class logits N(0, 8), objectness N(-4, 2)) at B=8 and
   B=128: two launches a call; nodes, keep masks and kept corners identical
   to the plain version run on the card, scores within 2 ulps
   (``tests/test_torch_cuda_tree.py``'s tolerance); the walk counters equal
   to the plain walk's; the call's times in turns with the plain version,
   its device time from a CUDA graph of calls and its bytes bound (the head
   read once, the picks written); (c) the 1 024 → 28 269 head conv alone at
   B=128 (cuDNN, ``channels_last`` bf16) at its own width and at the padded
   width 28 272 the engine runs: the kernels cuDNN launches, device ms in a
   CUDA graph of calls, and its FLOPs bound.  Prints ``{"tree": {...}}``.

Prints a ``{"kernels": [...]}`` JSON line (per kernel: launches on the main
paths, the eval path's two runs, the deploy phase's detect, export replays
and pruned models, the data-parallel phase's detect and every rank's eval,
the two gates' evals, the bench's runs and phase 17's (both nodes' eval,
the COCO-80 tool, the runner's two jobs) included, max abs err, ms, plain_ms,
bound_ms, bound_by and library_ms at batch 8, null where no PyTorch call
computes the function), then, last, ``{"ok": true, "device": {...}}``.
Wherever a phase counts launches it holds them to what the engine's route
and the post step give for the calls it makes (``Inference.launches``):
the one-pass epilogue (``bias_leaky_nhwc``) for each conv of a folded
forward whose epilogue no pool, reorg or depthwise kernel takes, none in a
train step.
Times are information, not a benchmark.  The train step runs no
hand-written kernel (the JAX package trains with every Pallas kernel off);
the detect on its checkpoint runs the fused decode+NMS and the one-pass
epilogue.  Eval runs those two (or nms_select in place of the first with
``pallas = nms``), on one device or on each rank.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from yolojax_torch.tools.kernel_timing import PEAK_BF16, PEAK_BYTES, PEAK_F32

ROOT = Path(__file__).resolve().parent
THRESHOLD, OVERLAP, TOPK = 0.005, 0.45, 100
EVAL_TOPK, EVAL_BATCH = 300, 16    # config.ini's [eval] topk and batch_size
BENCH_OBJECTNESS = -6.0     # background-dominated scores, as bench.py sets them
# (B, H, W, A, C): VOC at 416 and 608, COCO's 80 classes, an odd tiny grid
GEOMETRIES = [(8, 13, 13, 5, 20), (8, 19, 19, 5, 20), (2, 13, 13, 5, 80), (1, 4, 3, 2, 3)]
# eval's batch at 416 and 608 (N = 845, 1805), and COCO's 80 classes at both
EVAL_GEOMETRIES = [(16, 13, 13, 5, 20), (16, 19, 19, 5, 20), (16, 13, 13, 5, 80),
                   (16, 19, 19, 5, 80)]
REPS = 7
PROFILE_TRIES = 3           # torch.profiler captures tried before a profile is "not measured"
SIZE = 416                  # input size of every model, config.ini's [data] sizes
TIME_BATCHES = (8, 128)
MOBILENET_TOKENS = "nms fusedpost dwsep dwconv"
S2D_TOKENS = "nms pool reorg"
TINY_TOKENS = "nms fusedpost pool"
REORG_SHAPE = (26, 64)      # c21's output at 416: (B, 26, 26, 64) -> (B, 13, 13, 256)
REORG_TAIL = 1024           # the passthrough's top, (B, 13, 13, 1024), concatenated after it
# the one-pass epilogue's timed conv outputs, (H, C, the padded width or None), and
# the share of the bytes bound's rate its device time must reach at batch 128:
# Darknet-19's largest (c1) and one of its deepest (c20) at 416, and YOLO9000's
# head at 544, the first 28 269 channels of its conv's 28 272 (engine.padded_width;
# 76.2-85.9 % in three smoke runs on H100s at 700 W, 86.4 % into one preallocated output)
EPILOGUE_SHAPES = {"c1": (416, 32, None), "c20": (13, 1024, None),
                   "head9k": (17, 28269, 28272)}
EPILOGUE_TARGETS = {"c1": 0.80, "c20": 0.65, "head9k": 0.75}
KERNELS = ("postprocess_fused", "dwconv3x3", "dwsep", "nms_select", "maxpool2x2", "reorg_s2d",
           "bias_leaky_nhwc", "tree_decode")


def per_batch(**counts) -> dict:
    """Kernel launches per detect_fn batch: the named counts, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNELS}


def scaled(per_call: dict, n: int) -> dict:
    """The launches of ``n`` calls that each launch ``per_call``."""
    return {name: count * n for name, count in per_call.items()}


def summed(*counts: dict) -> dict:
    """The launches of several runs together."""
    return {name: sum(c[name] for c in counts) for name in KERNELS}


def model_of(config):
    """The model ``config`` builds, without weights."""
    from yolojax_torch.cli.common import build

    return build(config)[2]


def launches_of(model, calls: int = 1, size: int = SIZE, post: bool = True) -> dict:
    """The launches of ``calls`` detect calls of ``model`` on ``size``² images
    (of its forwards alone without ``post``), every kernel of KERNELS named:
    what the engine's route and the post step launch
    (``Inference.launches``)."""
    from yolojax_torch.models.inference import Inference

    return scaled(per_batch(**Inference(model).launches(size, post=post)), calls)


def routed(model, kernel: str) -> list:
    """The steps of ``model``'s route at SIZE that launch ``kernel``."""
    from yolojax_torch.models.engine import route

    return [s for s in route(model.plan, pallas=model.pallas, reorg_order=model.reorg_order,
                             dtype=model.dtype, channels=3, height=SIZE, width=SIZE)
            if s.kernel == kernel]


def pooled(model) -> list:
    """The fused pools of a forward: (H, C) of the raw conv output each takes
    and whether its full epilogue output is kept (Darknet's c13, for the
    passthrough)."""
    return [(s.shape[1], s.shape[0], s.key is not None) for s in routed(model, "maxpool2x2")
            if s.layer is not None]


def depthwise(model, kernel: str) -> list:
    """The layers of a forward on ``kernel`` (dwconv3x3 or dwsep), per shape
    in route order: (count, H, C, Cout, stride)."""
    shapes = Counter((s.shape[1], s.shape[0], (s.arg or s.layer).out_ch, s.layer.stride)
                     for s in routed(model, kernel))
    return [(count, *shape) for shape, count in shapes.items()]


# kernel-vs-plain cases beyond the routed shapes: odd spatial sizes, C % 128 != 0
# (2, 37, ...): the last 16-row tile of the 37 output rows holds 5; (1, 400, ...) and
# (1, 600, ...) walk each row in two column tiles
DWCONV_EXTRA = [(8, 27, 128, 128, 2), (8, 13, 1024, 1024, 2), (2, 13, 72, 72, 1),
                (2, 13, 36, 36, 2), (2, 37, 128, 128, 1), (1, 400, 32, 32, 1),
                (1, 600, 16, 16, 2)]
DWSEP_EXTRA = [(8, 27, 64, 96, 2), (8, 13, 512, 1024, 2), (2, 13, 72, 40, 1), (2, 13, 36, 40, 1),
               (3, 13, 1024, 1024, 1), (128, 26, 512, 512, 1)]
# C = 3 and 36: not a whole 16-byte unit of channels (one-lane kernels)
POOL_EXTRA = [(8, 26, 26, 72), (2, 2, 2, 128), (2, 2, 2, 72), (3, 6, 4, 3), (2, 6, 6, 36)]
REORG_EXTRA = [((2, 26, 26, 3), 5), ((2, 26, 26, 72), 16), ((2, 2, 2, 64), 8), ((2, 2, 2, 3), 6)]
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# flop/s by operand type (bf16 on the tensor cores, f32 on the CUDA cores):
# tools/kernel_timing.py's H100 SXM peaks
PEAK_FLOPS = {"bf16 tensor": PEAK_BF16, "f32": PEAK_F32}
HOST_ROUNDS, HOST_CALLS = 7, 300   # host-time measurement: median of rounds of calls


def log(msg: str) -> None:
    print(msg, flush=True)


class Bound:
    """The least time the card could take for a sum of calls: per call the
    larger of its bytes over the memory rate and its operations over the
    peak rate of their type (types run on separate units, so the slowest
    type counts)."""

    def __init__(self):
        self.ms = {"bytes": 0.0, "operations": 0.0}

    def add(self, nbytes: float, flops: dict | None = None, count: int = 1) -> "Bound":
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = max((n / PEAK_FLOPS[kind] * 1e3 for kind, n in (flops or {}).items()),
                    default=0.0)
        by = "bytes" if t_bytes >= t_ops else "operations"
        self.ms[by] += count * max(t_bytes, t_ops)
        return self

    @property
    def total(self) -> float:
        return self.ms["bytes"] + self.ms["operations"]

    @property
    def by(self) -> str:
        return max(self.ms, key=self.ms.get)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run needs an NVIDIA GPU")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    log(f"[device] torch: {name}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"[device] nvidia-smi name, power.limit: {card}")
    return name, card


def build_kernels() -> None:
    from yolojax_torch.kernels import (_build, dwconv, dwsep, epilogue, nms, pool,
                                       postprocess_fused, reorg)

    t0 = time.perf_counter()
    libs = _build.build_all([postprocess_fused.SOURCE, dwconv.SOURCE, dwsep.SOURCE, nms.SOURCE,
                             pool.SOURCE, reorg.SOURCE, epilogue.SOURCE])
    log(f"[build] {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.2f} s "
        "(in parallel)")
    for lib in libs:
        report = lib.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log(f"[build] ptxas {lib.name.split('-')[0]}: {line.strip()}")
    # the bf16 dwsep kernel must run its product on the tensor cores: wgmma is
    # HGMMA in the SASS
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        log(f"[build] no {cuobjdump}: the SASS of dwsep is not inspected")
        return
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(libs[2])], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    per_kernel, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif "HGMMA" in line and name:
            per_kernel[name] = per_kernel.get(name, 0) + 1
    log(f"[build] dwsep SASS: HGMMA instructions per function {per_kernel}")
    if not any("wgmma" in k for k in per_kernel):
        raise AssertionError("dwsep: the bf16 kernel's SASS has no HGMMA")


def compare(got, want, c: int, what: str) -> float:
    """Kept slots identical in order (every kept slot picks the plain
    version's box), conf to rtol 1e-5 (2e-5 at C=80), corners to atol 1e-5;
    returns the largest abs difference.  The plain decode sums the softmax
    in class order as the fused kernel does (``ops/decode.py``), so their
    scores agree bit for bit and no near tie may take another order."""
    keep = want.keep.cpu().numpy()
    if not np.array_equal(got.keep.cpu().numpy(), keep):
        raise AssertionError(f"{what}: keep differs "
                             f"({int(got.keep.sum())} kept vs {int(keep.sum())} plain)")
    rtol = 2e-5 if c == 80 else 1e-5
    conf_got, conf_want = (np.where(keep, t.conf.cpu().numpy(), 0) for t in (got, want))
    np.testing.assert_allclose(conf_got, conf_want, rtol=rtol, atol=0, err_msg=f"{what}: conf")
    err = float(np.abs(conf_got - conf_want).max(initial=0.0))
    for name in ("yx_min", "yx_max"):
        g, w = getattr(got, name).cpu().numpy(), getattr(want, name).cpu().numpy()
        off = keep & (np.abs(g - w) > 1e-5).any(-1)
        if off.any():
            raise AssertionError(f"{what}: {int(off.sum())} of {int(keep.sum())} kept slots "
                                 f"pick other boxes than the plain version ({name})")
        err = max(err, float(np.abs(np.where(keep[..., None], g - w, 0)).max(initial=0.0)))
    return err


def seeded_raw(rng, b, h, w, a, c, density: str) -> np.ndarray:
    """A raw head from numpy: normal logits, or (bench) objectness near −6."""
    raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 2).astype(np.float32)
    if density == "bench":
        obj = raw.reshape(b, h, w, a, 5 + c)[..., 4]
        obj[...] = BENCH_OBJECTNESS + 0.5 * obj
    return raw


def compacted(det) -> int:
    """The longest compacted row of a decoded head: the most candidates of
    one (image, class) whose score is > THRESHOLD, which the greedy loop of
    both NMS kernels walks."""
    return int((det.conf > THRESHOLD).sum(1).max().item())


def fused_case(head, anchors, c: int, what: str, topk: int) -> float:
    """The fused kernel against decode + the plain postprocess on one raw
    head; returns the largest abs difference (see ``compare``)."""
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.postprocess import postprocess

    got = postprocess_fused(head, anchors, THRESHOLD, OVERLAP, topk)
    det = decode(head, torch.as_tensor(anchors, device=head.device))
    want = postprocess(det, THRESHOLD, OVERLAP, topk)
    torch.cuda.synchronize()
    err = compare(got, want, c, what)
    picks = want.keep.sum(-1)
    log(f"[kernel] fused {what}: match, {int(picks.sum())} picks (most in one row "
        f"{int(picks.max())}), longest compacted row {compacted(det)} of {det.conf.shape[1]}, "
        f"max abs err {err:.3g}")
    return err


def fused_vs_plain(geometries=GEOMETRIES, topk: int = TOPK, seed: int = 0) -> float:
    rng = np.random.default_rng(seed)
    worst, cases = 0.0, 0
    for b, h, w, a, c in geometries:
        anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
        for density in ("bench", "saturated"):
            raw = seeded_raw(rng, b, h, w, a, c, density)
            for dtype in (torch.float32, torch.bfloat16):
                head = torch.from_numpy(raw).to("cuda", dtype)
                what = f"({b},{h},{w},{a * (5 + c)}) {density} {str(dtype)[6:]} topk {topk}"
                worst, cases = max(worst, fused_case(head, anchors, c, what, topk)), cases + 1
    log(f"[kernel] fused at topk {topk}: {cases} cases match the plain version; max abs err "
        f"{worst:.3g}")
    return worst


class _KernelNodeParams(ctypes.Structure):
    """The driver's ``CUDA_KERNEL_NODE_PARAMS_v2``."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


# the CUDA driver API's CUgraphNodeType values other than a kernel's (0)
GRAPH_NODE_TYPES = {1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
                    6: "wait_event", 7: "event_record", 8: "ext_semas_signal",
                    9: "ext_semas_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
                    13: "conditional"}


def captured_work(fn) -> list[str]:
    """What ``fn()`` puts on the current stream, read from a CUDA graph
    capture of it: each kernel node's (mangled) name, and ``<memset>``,
    ``<memcpy>`` ... for the nodes that are no kernel.  Unlike
    ``torch.profiler``, which drops device events on some H100 machines, a
    capture records every launch; ``fn`` must have run once before, so that
    its first-call set-up (builds, attributes) is not captured."""
    cuda = ctypes.CDLL("libcuda.so.1")

    def check(what: str, err: int) -> None:
        if err:
            raise AssertionError(f"captured_work: {what} returned CUresult {err}")

    def name_of(node) -> str:
        params = _KernelNodeParams()
        check("cuGraphKernelNodeGetParams_v2", cuda.cuGraphKernelNodeGetParams_v2(
            node, ctypes.byref(params)))
        name = ctypes.c_char_p()
        # the runtime launches a CUkernel cast to a CUfunction where it
        # loads lazily; either names it
        for get, handle in (("cuFuncGetName", params.func), ("cuKernelGetName", params.func),
                            ("cuKernelGetName", params.kern)):
            if handle and getattr(cuda, get)(ctypes.byref(name), ctypes.c_void_p(handle)) == 0:
                return name.value.decode()
        raise AssertionError("captured_work: the CUDA driver names no function of a kernel node")

    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    try:
        raw, count = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
        check("cuGraphGetNodes", cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)))
        nodes = (ctypes.c_void_p * count.value)()
        check("cuGraphGetNodes", cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)))
        work = []
        for node in nodes:
            kind = ctypes.c_int()
            check("cuGraphNodeGetType", cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                                                ctypes.byref(kind)))
            work.append(name_of(ctypes.c_void_p(node)) if kind.value == 0
                        else f"<{GRAPH_NODE_TYPES.get(kind.value, kind.value)}>")
        return work
    finally:
        graph.reset()


def fused_one_launch() -> None:
    """One postprocess_fused call issues exactly one device kernel (no
    upcast, no keep, no memset or copy): a CUDA graph capture of one call
    on a bf16 Darknet-416 head, anchors already on the card, at detect's
    point (batch 8, topk 100) and at eval's (batch 16, topk 300)."""
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused

    rng = np.random.default_rng(12)
    anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (5, 2)).astype(np.float32)).cuda()
    for b, topk in ((8, TOPK), (EVAL_BATCH, EVAL_TOPK)):
        raw = torch.from_numpy(seeded_raw(rng, b, 13, 13, 5, 20, "bench")).to("cuda",
                                                                              torch.bfloat16)
        postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, topk)
        device = captured_work(lambda: postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, topk))
        if len(device) != 1 or "postprocess_fused" not in device[0]:
            raise AssertionError(f"postprocess_fused: one call (batch {b}, topk {topk}) put "
                                 f"{len(device)} nodes {device} on the stream; expected the "
                                 "fused kernel alone")
        log(f"[kernel] fused: one call at batch {b}, topk {topk} issues one device kernel "
            f"({device[0][:60]})")


def dw_inputs(rng, b, h, c, cout, dtype):
    """Seeded (x, taps, bd, wp, bp) on the card; He-scaled weights."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).cuda()
    x = f(rng.standard_normal((b, h, h, c))).to(dtype)
    wd = f(rng.standard_normal((3, 3, c)) * np.sqrt(2 / 9)).to(dtype)
    wp = f(rng.standard_normal((c, cout)) * np.sqrt(2 / c)).to(dtype)
    return x, wd, f(rng.normal(0, 0.1, c)), wp, f(rng.normal(0, 0.1, cout))


def dw_vs_plain() -> dict:
    """dwconv3x3 and dwsep against their plain versions; worst abs err each.
    dwconv3x3 must also be bit-identical to its tap-order reference, computed
    on the card with separate torch ops."""
    from yolojax_torch.kernels.dwconv import dwconv3x3, dwconv3x3_plain, dwconv3x3_taps
    from yolojax_torch.kernels.dwsep import dwsep, dwsep_plain

    rng = np.random.default_rng(4)
    worst = {"dwconv3x3": 0.0, "dwsep": 0.0}
    mobilenet = model_of(mobilenet_config())
    cases = [("dwconv3x3", 8, *layer[1:]) for layer in depthwise(mobilenet, "dwconv3x3")]
    cases += [("dwconv3x3", *case) for case in DWCONV_EXTRA]
    cases += [("dwsep", 8, *layer[1:]) for layer in depthwise(mobilenet, "dwsep")]
    cases += [("dwsep", *case) for case in DWSEP_EXTRA]
    for name, b, h, c, cout, stride in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, wd, bd, wp, bp = dw_inputs(rng, b, h, c, cout, dtype)
            if name == "dwconv3x3":
                got, want = dwconv3x3(x, wd, bd, stride), dwconv3x3_plain(x, wd, bd, stride)
            else:
                got, want = (dwsep(x, wd, bd, wp, bp, stride),
                             dwsep_plain(x, wd, bd, wp, bp, stride))
            torch.cuda.synchronize()
            what = f"{name} {(b, h, h, c)}->{tuple(want.shape)} s{stride} {str(dtype)[6:]}"
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{what}: kernel gave {tuple(got.shape)} {got.dtype}")
            tol = TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol,
                                       msg=lambda m: f"{what}: {m}")
            err = (got.float() - want.float()).abs().max().item()
            differ = (got != want).float().mean().item()
            worst[name] = max(worst[name], err)
            taps = ""
            if name == "dwconv3x3":
                check_bits(got, dwconv3x3_taps(x, wd, bd, stride), f"{what} vs the tap order")
                taps = "; bit-identical to the tap-order reference"
            log(f"[kernel] {what}: match, max abs err {err:.3g}, "
                f"{100 * differ:.4f} % of elements not bit-identical to the plain version{taps}")
    log(f"[kernel] depthwise: {2 * len(cases)} cases match the plain versions; "
        f"max abs err {worst}")
    return worst


def decoded(rng, b, h, w, a, c, density: str):
    """A seeded raw head decoded on the card: (Detections, anchors)."""
    from yolojax_torch.ops.decode import decode

    anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)).cuda()
    raw = torch.from_numpy(seeded_raw(rng, b, h, w, a, c, density)).cuda()
    return decode(raw, anchors)


def nms_vs_plain() -> float:
    """nms_select against its plain version: idx, conf and valid identical,
    boxes broadcast over the classes and not; postprocess_nms as postprocess."""
    from yolojax_torch.kernels.nms import nms_select, postprocess_nms
    from yolojax_torch.ops.nms import nms_select as nms_plain
    from yolojax_torch.ops.postprocess import postprocess

    rng = np.random.default_rng(8)
    worst, cases = 0.0, 0
    for b, h, w, a, c in GEOMETRIES:
        for density in ("bench", "saturated"):
            det = decoded(rng, b, h, w, a, c, density)
            n = det.conf.shape[1]
            scores = det.conf.transpose(1, 2)
            boxes = {"broadcast": (det.yx_min[:, None], det.yx_max[:, None]),
                     "per class": (det.yx_min[:, None].expand(b, c, n, 2).contiguous(),
                                   det.yx_max[:, None].expand(b, c, n, 2).contiguous())}
            max_outs = (TOPK, 300) if (h, density) == (19, "saturated") else (TOPK,)
            for (layout, (yx_min, yx_max)) in boxes.items():
                for max_out in max_outs:
                    got = nms_select(yx_min, yx_max, scores, THRESHOLD, OVERLAP, max_out)
                    want = nms_plain(yx_min, yx_max, scores, THRESHOLD, OVERLAP, max_out)
                    torch.cuda.synchronize()
                    what = f"nms_select ({b},{c},{n}) {density} boxes {layout} max_out {max_out}"
                    for g, v, part in zip(got, want, ("idx", "conf", "valid")):
                        if g.shape != v.shape or g.dtype != v.dtype or not torch.equal(g, v):
                            raise AssertionError(f"{what}: {part} differs")
                    err = (got[1] - want[1]).abs().max().item()
                    worst, cases = max(worst, err), cases + 1
                    log(f"[kernel] {what}: identical, {int(want[2].sum())} picks, longest "
                        f"compacted row {compacted(det)}")
            got = postprocess_nms(det, THRESHOLD, OVERLAP, TOPK)
            want = postprocess(det, THRESHOLD, OVERLAP, TOPK)
            err = compare(got, want, c, f"postprocess_nms ({b},{c},{n}) {density}")
            worst, cases = max(worst, err), cases + 1
    log(f"[kernel] nms_select: {cases} cases match the plain version; max abs err {worst:.3g}")
    return worst


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def check_bits(got, want, what: str) -> float:
    """Same shape, dtype and bits; returns the largest abs difference (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
                             f"{tuple(want.shape)} {want.dtype}")
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"{what}: not bit-identical "
                             f"({(got != want).float().mean().item() * 100:.4f} % differ)")
    return (got.float() - want.float()).abs().max().item()


def layout_vs_plain() -> dict:
    """maxpool2x2 and reorg_s2d against their plain versions, bit-identical:
    the bare kernels, and their fused modes (bias + leaky; the pool's full
    output; the reorg's concat) on raw inputs with NaN, ±inf and signed
    zeros sprinkled in."""
    from yolojax_torch.kernels.pool import maxpool2x2, maxpool2x2_plain
    from yolojax_torch.kernels.reorg import reorg_s2d, reorg_s2d_plain

    rng = np.random.default_rng(9)
    worst = {"maxpool2x2": 0.0, "reorg_s2d": 0.0}
    pools = [(8, h, h, c) for config in (darknet_config(), tiny_config())
             for h, c, _ in pooled(model_of(config))] + POOL_EXTRA
    reorgs = [((8, REORG_SHAPE[0], REORG_SHAPE[0], REORG_SHAPE[1]), REORG_TAIL)] + REORG_EXTRA
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape in pools:
            x = special(rng, shape, dtype)
            bias = torch.from_numpy(rng.normal(0, 0.5, shape[-1]).astype(np.float32)).cuda()
            for args in ((), (bias, True, False), (bias, True, True), (bias, False, True)):
                got, want = maxpool2x2(x, *args), maxpool2x2_plain(x, *args)
                torch.cuda.synchronize()
                what = f"maxpool2x2 {shape} {str(dtype)[6:]} {pool_mode(args)}"
                for g, w in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
                    worst["maxpool2x2"] = max(worst["maxpool2x2"], check_bits(g, w, what))
                cases += 1
            log(f"[kernel] maxpool2x2 {shape}->{tuple(want[0].shape)} {str(dtype)[6:]}: bare "
                "and fused (act, act + full, full without act) bit-identical")
        for shape, ct in reorgs:
            b, h, w, c = shape
            x = special(rng, shape, dtype)
            tail = special(rng, (b, h // 2, w // 2, ct), dtype)
            bias = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)).cuda()
            for args in ((), (tail,), (tail, bias, True), (tail, bias, False), (None, bias)):
                got, want = reorg_s2d(x, 2, *args), reorg_s2d_plain(x, 2, *args)
                torch.cuda.synchronize()
                what = f"reorg_s2d {shape} {str(dtype)[6:]} {len(args)} extra arguments"
                worst["reorg_s2d"] = max(worst["reorg_s2d"], check_bits(got, want, what))
                cases += 1
            log(f"[kernel] reorg_s2d {shape} tail {ct} {str(dtype)[6:]}: bare, with the "
                "concat and with bias + leaky, bit-identical")
    log(f"[kernel] pool and reorg: {cases} cases bit-identical to the plain versions")
    return worst


def special(rng, shape, dtype) -> torch.Tensor:
    """Seeded normal values on the card with NaN, ±inf and signed zeros in
    one element of 64."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    picks = rng.choice(flat.size, size=max(1, flat.size // 64), replace=False)
    flat[picks] = rng.choice(np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32),
                             size=picks.size)
    return torch.from_numpy(x).to("cuda", dtype)


def pool_mode(args) -> str:
    if not args:
        return "bare"
    return "fused" + (" act" if args[1] else "") + (" full" if args[2] else "")


def cuda_ms(fn, reps: int = REPS, warmup: int = 3) -> list[float]:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def in_turns(*fns) -> tuple[float, ...]:
    """Medians of ``fns`` timed in turns on one card, forth and back: for
    (plain, kernel) plain, kernel, kernel, plain; 8 runs each."""
    half = REPS // 2 + 1
    times = [cuda_ms(fn, half) for fn in fns]
    for i in reversed(range(len(fns))):
        times[i] += cuda_ms(fns[i], half)
    return tuple(float(np.median(t)) for t in times)


def launch_counters():
    from yolojax_torch.kernels.dwconv import dwconv3x3
    from yolojax_torch.kernels.dwsep import dwsep
    from yolojax_torch.kernels.epilogue import bias_leaky_nhwc
    from yolojax_torch.kernels.nms import nms_select
    from yolojax_torch.kernels.pool import maxpool2x2
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.kernels.reorg import reorg_s2d
    from yolojax_torch.kernels.tree import tree_decode

    return {"postprocess_fused": postprocess_fused, "dwconv3x3": dwconv3x3, "dwsep": dwsep,
            "nms_select": nms_select, "maxpool2x2": maxpool2x2, "reorg_s2d": reorg_s2d,
            "bias_leaky_nhwc": bias_leaky_nhwc, "tree_decode": tree_decode}


def seeded_images(seed: int, b: int, size: int = SIZE) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (b, size, size, 3))
                            .astype(np.float32)).cuda()


def drive(config, what: str):
    """Drive ``detect_fn`` on seeded batches of 8 at the configured size, with
    every launch counter set to 0 just before and read just after; check the
    counts against the route's, the outputs and the plain postprocess of the
    same raw heads, then ``detect_image``.  Returns (model, params, state,
    folded, run, launches)."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.detect import detect_image
    from yolojax_torch.models.inference import Inference
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.postprocess import postprocess

    category, anchors, model = build(config)
    size = int(config.get("data", "sizes").split(",")[0])
    params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
    params["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = BENCH_OBJECTNESS
    inference = Inference(model)
    folded = inference.fold(params, state)
    run = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
    n_params = sum(lp["w"].numel() + lp["b"].numel() for lp in folded.values())
    log(f"[{what}] {type(model).__name__} {size}x{size}, {len(category)} classes, "
        f"{len(anchors)} anchors, {model.dtype}, reorg {model.reorg_order}, kernels "
        f"{sorted(model.pallas)}, {n_params} folded params")

    rng = np.random.default_rng(1)
    batches = [torch.from_numpy(rng.uniform(0, 1, (8, size, size, 3)).astype(np.float32))
               .to("cuda") for _ in range(3)]
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = [run(folded, x) for x in batches]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = launches_of(model, len(batches), size)
    if launches != want:
        raise AssertionError(f"{what}: {len(batches)} batches launched {launches}, "
                             f"expected {want}")
    anchors_t = torch.as_tensor(anchors, device="cuda")
    with torch.inference_mode():
        for i, (x, out) in enumerate(zip(batches, outs)):
            shape = (8, model.num_classes, TOPK)
            if out.conf.shape != shape or out.yx_min.shape != (*shape, 2):
                raise AssertionError(f"{what} batch {i}: output shape {tuple(out.conf.shape)}")
            if not all(bool(torch.isfinite(t).all()) for t in (out.yx_min, out.yx_max, out.conf)):
                raise AssertionError(f"{what} batch {i}: non-finite outputs")
            raw = model.apply_folded(folded, x)
            if raw.shape != (8, size // 32, size // 32, model.out_channels):
                raise AssertionError(f"{what} batch {i}: raw head {tuple(raw.shape)}")
            det = decode(raw, anchors_t)
            plain = postprocess(det, THRESHOLD, OVERLAP, TOPK)
            compare(out, plain, model.num_classes, f"{what} batch {i}")
            picks = out.keep.sum(-1).float()
            log(f"[{what}] batch {i}: raw {tuple(raw.shape)} {raw.dtype}, keep matches the "
                f"plain postprocess; picks per (image, class) mean {picks.mean().item():.2f} "
                f"max {int(picks.max().item())}; longest compacted row {compacted(det)}")
    log(f"[{what}] detect_fn ran {len(batches)} batches; launches {launches}")

    image = np.random.default_rng(2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    ymin, ymax, cls, conf = detect_image(config, model, params, state, image, size)
    if not (ymin.shape == ymax.shape == (len(cls), 2) and len(conf) == len(cls)
            and np.isfinite(conf).all()):
        raise AssertionError(f"{what}: detect_image returned malformed detections")
    log(f"[{what}] detect_image on a 480x640 image returned {len(cls)} detections "
        f"(threshold {config.getfloat('detect', 'threshold')})")
    return model, params, state, folded, run, launches


def dense_batch(model, folded, run, what: str) -> None:
    """At the bench density a random head leaves every score under the
    threshold; hold the path's detections to the plain postprocess where there
    are picks too: objectness bias 0 on one more batch."""
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.postprocess import postprocess

    dense = dict(folded, out=dict(folded["out"], b=folded["out"]["b"].clone()))
    dense["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = 0.0
    x = seeded_images(7, 8)
    with torch.inference_mode():
        out = run(dense, x)
        det = decode(model.apply_folded(dense, x), torch.as_tensor(model.anchors, device="cuda"))
        plain = postprocess(det, THRESHOLD, OVERLAP, TOPK)
        compare(out, plain, model.num_classes, f"{what} dense batch")
    picks = out.keep.sum(-1).float()
    if not picks.max() > 0:
        raise AssertionError(f"{what} dense batch: no picks to compare")
    log(f"[{what}] dense batch (objectness bias 0): keep matches the plain postprocess; "
        f"picks per (image, class) mean {picks.mean().item():.2f} max {int(picks.max().item())}; "
        f"longest compacted row {compacted(det)} of {det.conf.shape[1]}")


def without(model, tokens: set):
    """The same model with the kernel ``tokens`` removed: it runs on the same
    folded weights (the plain path reads only their ``w`` and ``b``).  Its
    forward is the plain path only under :func:`plain_epilogue`."""
    return dataclasses.replace(model, pallas=model.pallas - set(tokens))


@contextlib.contextmanager
def epilogue_as(fn, pool=None):
    """While inside, the engine's conv epilogues that no other kernel takes
    call ``fn(x, bias, act)`` in place of ``kernels/epilogue.py``'s wrapper,
    and with ``pool`` its pools call ``pool`` in place of
    ``kernels/pool.py``'s: two of the entry points ``engine._launchers``
    hands each forward.  The wrappers themselves are left as they are (each
    counts its launches on itself)."""
    from yolojax_torch.models import engine

    launchers = engine._launchers

    def patched():
        dw, sep, maxpool, reorg, _ = launchers()
        return dw, sep, pool or maxpool, reorg, fn

    engine._launchers = patched
    try:
        yield
    finally:
        engine._launchers = launchers


def plain_epilogue():
    """While inside, those epilogues run as ``bias_leaky`` (six torch ops, a
    pass each) in place of the one-pass kernel, and the conv → pool pairs as
    ``maxpool2x2_plain`` (``bias_leaky`` then ``F.max_pool2d``) in place of
    the pool kernel: with :func:`without`, the plain path."""
    from yolojax_torch.kernels.epilogue import bias_leaky_nhwc_plain
    from yolojax_torch.kernels.pool import maxpool2x2_plain

    return epilogue_as(bias_leaky_nhwc_plain, maxpool2x2_plain)


def plain_label(drop: set) -> str:
    """What the plain path runs without: the tokens ``drop`` and the two
    kernels :func:`plain_epilogue` replaces."""
    return " ".join([*sorted(drop), "bias_leaky_nhwc", "maxpool2x2"])


def plain(fn):
    """``fn`` run under :func:`plain_epilogue` at each call."""
    def call(*args, **kwargs):
        with plain_epilogue():
            return fn(*args, **kwargs)
    return call


def epilogue_vs_plain(model, folded, what: str) -> float:
    """One batch-8 forward of the path, every call it makes to the one-pass
    epilogue checked on the conv output it hands over: bit-identical to
    ``bias_leaky`` (six torch ops) on the same tensor.  Returns the largest
    abs error (0 where they agree)."""
    from yolojax_torch.kernels.epilogue import bias_leaky_nhwc, bias_leaky_nhwc_plain

    calls = []

    def checked(x, bias, act=True):
        y = bias_leaky_nhwc(x, bias, act)
        want = bias_leaky_nhwc_plain(x, bias, act)
        calls.append((tuple(x.shape), float((y.float() - want.float()).abs().max())))
        if not torch.equal(bits(y), bits(want)):
            raise AssertionError(f"{what}: bias_leaky_nhwc on the conv output "
                                 f"{tuple(x.shape)} {x.dtype} (act {act}) differs from "
                                 f"bias_leaky (max abs diff {calls[-1][1]:.4g})")
        return y

    with epilogue_as(checked), torch.inference_mode():
        model.apply_folded(folded, seeded_images(6, 8))
    err = max(e for _, e in calls)
    log(f"[{what}] bias_leaky_nhwc bit-identical to bias_leaky on every epilogue of a "
        f"batch-8 forward: {len(calls)} calls, shapes from {calls[0][0]} to {calls[-1][0]}")
    return err


def raw_vs_without(model, folded, config_fn, drop: set, what: str, exact: bool,
                   size: int = SIZE) -> None:
    """The raw head against the plain path: the same forward without the
    kernels ``drop`` and with ``bias_leaky`` in place of the one-pass
    epilogue, on the same weights and images, in bf16 and (rebuilt from the
    same seed) in f32 with TF32 off.  ``exact``: kernels that change no
    value (pool, reorg, the epilogue), so the convs see the same inputs and
    the heads should be bit-identical; f32 must be, bf16 falls back to the
    1 % bound if cuDNN's algorithm choice differs.  Otherwise: bf16 mean
    abs diff ≤ 1 % of mean |raw|, f32 rtol/atol 1e-3.  Images at ``size``."""
    from yolojax_torch.cli.common import build, load_weights_auto

    label = plain_label(drop)
    x = seeded_images(5, 8, size)
    with torch.inference_mode():
        got = model.apply_folded(folded, x)
        want = plain(without(model, drop).apply_folded)(folded, x)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{what} bf16: non-finite raw head")
        diff = (got.float() - want.float()).abs()
        ratio = diff.mean().item() / want.float().abs().mean().item()
        same = torch.equal(bits(got), bits(want))
        log(f"[{what}] bf16 raw head vs the forward without {label}: "
            f"{'bit-identical' if same else 'not bit-identical'}, max abs diff "
            f"{diff.max().item():.4g}, mean abs diff {diff.mean().item():.4g} = "
            f"{100 * ratio:.3f} % of mean |raw| {want.float().abs().mean().item():.4g}")
        if exact and not same:
            log(f"[{what}] bf16 raw head differs although {label} change no value: cuDNN "
                "chose other algorithms for the two forwards; held to the 1 % bound instead")
        if not (same or ratio <= 0.01):
            raise AssertionError(f"{what} bf16: mean abs diff {100 * ratio:.3f} % > 1 %")

        config32 = config_fn(dtype="float32")
        _, _, model32 = build(config32)
        params32, state32, _ = load_weights_auto(config32, model32, rng_seed=0, device="cuda")
        folded32 = model32.fold(params32, state32)
        got = model32.apply_folded(folded32, x)
        want = plain(without(model32, drop).apply_folded)(folded32, x)
        if exact:
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"{what} f32 raw head: not bit-identical without {label} "
                                     f"(max abs diff {(got - want).abs().max().item():.4g})")
            log(f"[{what}] f32 raw head vs the forward without {label} (TF32 off): "
                "bit-identical")
        else:
            torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3,
                                       msg=lambda m: f"{what} f32 raw head without {label}: {m}")
            log(f"[{what}] f32 raw head vs the forward without {label} (TF32 off): max abs "
                f"diff {(got - want).abs().max().item():.4g} within rtol/atol 1e-3")


def darknet_config(dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    # the repo's config.ini: Darknet-19, VOC, bf16, fusedpost
    return load_config(None, [f"model/dtype={dtype}"])


def darknet_path():
    """The Darknet main path: drive it, then hold its raw head to the plain
    path's (``bias_leaky`` in place of the one-pass epilogue)."""
    model, _, _, folded, run, launches = drive(darknet_config(), "darknet")
    raw_vs_without(model, folded, darknet_config, set(), "darknet", exact=True)
    return model, folded, run, launches


def mobilenet_config(tokens: str = MOBILENET_TOKENS, dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    return load_config([str(ROOT / "config.ini"), str(ROOT / "config" / "mobilenet.ini")],
                       [f"model/pallas={tokens}", f"model/dtype={dtype}"])


def s2d_config(tokens: str = S2D_TOKENS, dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    return load_config([str(ROOT / "config.ini")],
                       ["model/reorg=s2d", f"model/pallas={tokens}", f"model/dtype={dtype}"])


def tiny_config(tokens: str = TINY_TOKENS, dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    return load_config([str(ROOT / "config.ini"), str(ROOT / "config" / "tiny.ini")],
                       [f"model/pallas={tokens}", f"model/dtype={dtype}"])


DW_TOKENS = {"dwsep", "dwconv"}


def kernel_path(what: str, config_fn, drop: set, exact: bool):
    """A main path through kernels of the forward: drive it, check a dense
    batch, and hold its raw head to the plain path's."""
    model, _, _, folded, run, launches = drive(config_fn(), what)
    dense_batch(model, folded, run, what)
    raw_vs_without(model, folded, config_fn, drop, what, exact)
    return model, folded, run, launches


def darknet_times(model, folded, run, card: str) -> dict:
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.postprocess import postprocess_raw

    anchors = torch.as_tensor(model.anchors, device=TRAIN_DEVICE)
    rng = np.random.default_rng(3)
    result = {}
    with torch.inference_mode():
        for b in TIME_BATCHES:
            x = torch.from_numpy(rng.uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)).cuda()
            raw = model.apply_folded(folded, x)
            t_plain, t_kernel = in_turns(
                lambda: postprocess_raw(raw, anchors, THRESHOLD, OVERLAP, TOPK),
                lambda: postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK))
            out = postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
            # bytes: the head and anchors in, the PostProcessed out; operations:
            # the decode (~3 per class score and 20 per candidate) and, for
            # this head's picks, an argmax and an IoU (~16) per candidate
            n, c = raw.shape[1] * raw.shape[2] * len(model.anchors), model.num_classes
            ops = b * n * (3 * c + 20) + int(out.keep.sum()) * n * 16
            bound = Bound().add(nbytes(raw, anchors, *out), {"f32": ops})
            t_fwd = float(np.median(cuda_ms(lambda: model.apply_folded(folded, x))))
            t_detect = cuda_ms(lambda: run(folded, x))
            med = float(np.median(t_detect))
            result[b] = {"kernel_ms": t_kernel, "plain_ms": t_plain, "forward_ms": t_fwd,
                         "detect_ms": med, "img_per_s": b / (med / 1e3),
                         "bound_ms": bound.total, "bound_by": bound.by}
            log(f"[time] {card} | raw {tuple(raw.shape)} {raw.dtype}: fused kernel "
                f"{t_kernel:.4f} ms, plain {t_plain:.4f} ms (median of 8 / 8); bound "
                f"{bound.total:.5f} ms by {bound.by}, {int(out.keep.sum())} picks; no "
                "PyTorch call computes it")
            log(f"[time] {card} | Darknet detect batch {b} at {SIZE}: {med:.3f} ms = "
                f"{result[b]['img_per_s']:.1f} img/s (forward alone {t_fwd:.3f} ms; "
                f"median of {REPS}); all runs {[round(t, 3) for t in t_detect]}")
    return result


def dw_times(card: str) -> dict:
    """Each routed layer shape, kernel against plain version and (dwconv3x3)
    the library's grouped conv, bf16, in turns; returns per (name, batch)
    the sums over one forward's routed layers, with their bound."""
    import torch.nn.functional as F

    from yolojax_torch.kernels.dwconv import dwconv3x3, dwconv3x3_plain
    from yolojax_torch.kernels.dwsep import dwsep, dwsep_plain

    rng = np.random.default_rng(6)
    mobilenet = model_of(mobilenet_config())
    sums = {}
    for b in TIME_BATCHES:
        for name in ("dwconv3x3", "dwsep"):
            layers = depthwise(mobilenet, name)
            total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
            bound = Bound()
            for count, h, c, cout, stride in layers:
                x, wd, bd, wp, bp = dw_inputs(rng, b, h, c, cout, torch.bfloat16)
                ho = (h - 1) // stride + 1
                pixels = b * ho * ho
                dw_flops = 2 * 9 * pixels * c
                if name == "dwconv3x3":
                    # the TPU kernel's function: the grouped conv, no epilogue
                    xc, weight = x.permute(0, 3, 1, 2), wd.permute(2, 0, 1).unsqueeze(1)
                    t_plain, t_kernel, t_lib = in_turns(
                        lambda: dwconv3x3_plain(x, wd, bd, stride),
                        lambda: dwconv3x3(x, wd, bd, stride),
                        lambda: F.conv2d(xc, weight, stride=stride, padding=1, groups=c))
                    work = (nbytes(x, wd, bd) + pixels * c * 2, {"f32": dw_flops})
                    flops = dw_flops
                else:
                    wp_t = wp.t().contiguous()
                    t_plain, t_kernel = in_turns(
                        lambda: dwsep_plain(x, wd, bd, wp, bp, stride),
                        lambda: dwsep(x, wd, bd, wp, bp, stride, wp_t))
                    t_lib = None
                    flops = 2 * pixels * c * cout
                    work = (nbytes(x, wd, bd, wp, bp) + pixels * cout * 2,
                            {"bf16 tensor": flops, "f32": dw_flops})
                layer = Bound().add(*work)
                bound.add(*work, count=count)
                total["ms"] += count * t_kernel
                total["plain_ms"] += count * t_plain
                total["library_ms"] = None if t_lib is None else total["library_ms"] + count * t_lib
                lib = "" if t_lib is None else f", library {t_lib:.4f} ms"
                log(f"[time] {card} | {name} ({b},{h},{h},{c})->{cout} s{stride} bf16: kernel "
                    f"{t_kernel:.4f} ms = {flops / t_kernel / 1e9:.1f} TFLOP/s, "
                    f"{100 * layer.total / t_kernel:.1f} % of its bound {layer.total:.4f} ms "
                    f"({layer.by}); plain {t_plain:.4f} ms{lib} (median of 8 / 8; "
                    f"{count}x per forward)")
            sums[(name, b)] = dict(total, bound_ms=bound.total, bound_by=bound.by)
            lib = ("" if total["library_ms"] is None
                   else f", library {total['library_ms']:.4f} ms")
            log(f"[time] {card} | {name} per MobileNet-416 forward at batch {b}: kernel "
                f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms{lib}, bound "
                f"{bound.total:.4f} ms ({bound.by}) = {100 * bound.total / total['ms']:.1f} % "
                "of the kernel's time")
    return sums


def detect_times(model, folded, run, drop: set, name: str, card: str) -> dict:
    """detect images/s with the path's kernels and on its plain path
    (without the forward kernels ``drop``, ``bias_leaky`` for the one-pass
    epilogue), in turns, at each timed batch."""
    from yolojax_torch.models.inference import Inference

    plain_run = plain(Inference(without(model, drop)).detect_fn(THRESHOLD, OVERLAP, TOPK))
    result = {}
    for b in TIME_BATCHES:
        x = seeded_images(3, b)
        t_plain, t_kernel = in_turns(lambda: plain_run(folded, x), lambda: run(folded, x))
        result[b] = {"detect_ms": t_kernel, "img_per_s": b / (t_kernel / 1e3),
                     "plain_detect_ms": t_plain, "plain_img_per_s": b / (t_plain / 1e3)}
        log(f"[time] {card} | {name} detect batch {b} at {SIZE}: with {sorted(model.pallas)} "
            f"{t_kernel:.3f} ms = {result[b]['img_per_s']:.1f} img/s; without "
            f"{plain_label(drop)} {t_plain:.3f} ms = "
            f"{result[b]['plain_img_per_s']:.1f} img/s (median of 8 / 8)")
    return result


def nms_times(model, folded, card: str) -> dict:
    """nms_select against its plain version on Darknet-s2d's decoded heads."""
    from yolojax_torch.kernels.nms import nms_select
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.nms import nms_select as nms_plain

    anchors = torch.as_tensor(model.anchors, device=TRAIN_DEVICE)
    result = {}
    with torch.inference_mode():
        for b in TIME_BATCHES:
            det = decode(model.apply_folded(folded, seeded_images(3, b)), anchors)
            args = (det.yx_min[:, None], det.yx_max[:, None], det.conf.transpose(1, 2),
                    THRESHOLD, OVERLAP, TOPK)
            t_plain, t_kernel = in_turns(lambda: nms_plain(*args), lambda: nms_select(*args))
            # bytes: boxes and scores in, idx, conf and valid out; operations:
            # an argmax and an IoU (~16) per candidate for each of this
            # head's picks
            picks = nms_select(*args)
            n = args[2].shape[-1]
            bound = Bound().add(nbytes(*args[:3], *picks), {"f32": int(picks[2].sum()) * n * 16})
            result[b] = {"ms": t_kernel, "plain_ms": t_plain, "library_ms": None,
                         "bound_ms": bound.total, "bound_by": bound.by}
            log(f"[time] {card} | nms_select scores {tuple(args[2].shape)}, boxes "
                f"{tuple(args[0].shape)}: kernel {t_kernel:.4f} ms, plain {t_plain:.4f} ms "
                f"(median of 8 / 8); bound {bound.total:.5f} ms by {bound.by}, "
                f"{int(picks[2].sum())} picks; no PyTorch call computes it")
    return result


def layout_times(card: str) -> dict:
    """The routed pools as the main paths run them, bf16, in turns: the fused
    maxpool2x2 on each conv's raw output (with c13's full output) against its
    plain version (``bias_leaky`` then ``F.max_pool2d``: torch's own ops, no
    kernel of the port) and against ``F.max_pool2d`` alone on the epilogue
    output (the one PyTorch call that computes the TPU kernel's function),
    summed per Darknet and per Tiny forward, and each call's device µs in a
    CUDA graph of back-to-back calls (:func:`graph_us`) beside its bound (a
    batch-8 input that stays in L2 between the calls can beat it); and the
    fused reorg + concat at
    c21's shape against its plain version (``bias_leaky``, the view chain,
    ``torch.cat``).  The bound counts the bytes each fused call must move."""
    import torch.nn.functional as F

    from yolojax_torch.kernels.pool import maxpool2x2, maxpool2x2_plain
    from yolojax_torch.kernels.reorg import reorg_s2d, reorg_s2d_plain
    from yolojax_torch.models.blocks import bias_leaky

    rng = np.random.default_rng(10)
    x_of = lambda shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    b_of = lambda c: torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)).cuda()
    result = {}
    models = {"Darknet": pooled(model_of(darknet_config())), "Tiny": pooled(model_of(tiny_config()))}
    for b in TIME_BATCHES:
        for model_name, pools in models.items():
            total = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
            bound = Bound()
            for h, c, full in pools:
                x, bias = x_of((b, h, h, c)), b_of(c)
                y = bias_leaky(x.permute(0, 3, 1, 2), bias)
                t_plain, t_kernel, t_lib = in_turns(
                    lambda: maxpool2x2_plain(x, bias, True, full),
                    lambda: maxpool2x2(x, bias, True, full),
                    lambda: F.max_pool2d(y, 2, 2))
                for key, t in zip(total, (t_kernel, t_plain, t_lib)):
                    total[key] += t
                calls = 20
                device_us = graph_us(lambda: maxpool2x2(x, bias, True, full), calls)
                # bytes: the raw output and the bias read, the pooled output (and
                # the full one) written; operations: the epilogue (an add, a
                # compare, a multiply) per element and three compares per output
                moved = nbytes(x, bias) + nbytes(x) // 4 + (nbytes(x) if full else 0)
                work = (moved, {"f32": 3 * x.numel() + 3 * x.numel() // 4})
                layer = Bound().add(*work)
                bound.add(*work)
                log(f"[time] {card} | maxpool2x2 fused ({b},{h},{h},{c}){' + full' * full} bf16: "
                    f"kernel {t_kernel:.4f} ms, device {device_us:.1f} us a call in a graph of "
                    f"{calls} = {moved / 1e3 / device_us:.0f} GB/s, "
                    f"{100 * layer.total * 1e3 / device_us:.1f} % of its bound "
                    f"{layer.total:.4f} ms ({layer.by}); plain (bias_leaky + F.max_pool2d) "
                    f"{t_plain:.4f} ms, F.max_pool2d alone {t_lib:.4f} ms (median of 8 / 8)")
            result[("maxpool2x2", model_name, b)] = dict(total, bound_ms=bound.total,
                                                         bound_by=bound.by)
            log(f"[time] {card} | maxpool2x2 per {model_name}-416 forward at batch {b}: kernel "
                f"{total['ms']:.4f} ms, plain {total['plain_ms']:.4f} ms, F.max_pool2d "
                f"{total['library_ms']:.4f} ms, bound {bound.total:.4f} ms ({bound.by})")
        x = x_of((b, REORG_SHAPE[0], REORG_SHAPE[0], REORG_SHAPE[1]))
        tail, bias = x_of((b, REORG_SHAPE[0] // 2, REORG_SHAPE[0] // 2, REORG_TAIL)), b_of(64)
        t_plain, t_kernel = in_turns(lambda: reorg_s2d_plain(x, 2, tail, bias),
                                     lambda: reorg_s2d(x, 2, tail, bias))
        moved = nbytes(x, tail, bias) + nbytes(x, tail)
        bound = Bound().add(moved, {"f32": 3 * x.numel()})
        result[("reorg_s2d", b)] = {"ms": t_kernel, "plain_ms": t_plain, "library_ms": None,
                                    "bound_ms": bound.total, "bound_by": bound.by}
        log(f"[time] {card} | reorg_s2d fused {tuple(x.shape)} + concat {tuple(tail.shape)} "
            f"bf16: kernel {t_kernel:.4f} ms = {moved / 1e9 / (t_kernel / 1e3):.0f} GB/s, "
            f"{100 * bound.total / t_kernel:.1f} % of its bound {bound.total:.5f} ms; plain "
            f"(bias_leaky, view chain, torch.cat) {t_plain:.4f} ms (median of 8 / 8); no "
            "PyTorch call computes it (pixel_unshuffle orders channels c*4+p*2+q)")
    return result


def graph_us(fn, calls: int) -> float:
    """Device µs a call of ``fn``: a CUDA graph of ``calls`` calls replayed
    between two CUDA events, over ``calls`` (median of 5 replays), so no
    host time lies between the launches, as a small call's wrapper would
    put there; ``torch.profiler`` drops device events on some machines."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    times = cuda_ms(graph.replay, reps=5, warmup=1)
    graph.reset()
    return float(np.median(times)) * 1e3 / calls


def epilogue_times(card: str) -> tuple[dict, float]:
    """The one-pass bias + leaky epilogue (``kernels/epilogue.py``) at
    EPILOGUE_SHAPES, bf16 with leaky, against its plain version
    (``bias_leaky``: six torch ops, each a pass over the activation): the
    outputs bit-identical; in turns, one call's ms on CUDA events (the
    wrapper's host time included); and a call's device µs in a CUDA graph of
    back-to-back calls (:func:`graph_us`), beside the bound (the raw output
    and the bias read once, the result written once, over 3.35 TB/s; a small
    output the next call reads from L2 can beat it).  At batch 128 the
    graph's time must reach EPILOGUE_TARGETS of the bound.  Returns (per
    (layer, batch) the row's numbers, the largest abs error)."""
    from yolojax_torch.kernels.epilogue import bias_leaky_nhwc, bias_leaky_nhwc_plain

    g = torch.Generator(device="cuda").manual_seed(11)
    result, short, err = {}, [], 0.0
    for b in TIME_BATCHES:
        for layer, (h, c, padded) in EPILOGUE_SHAPES.items():
            x = torch.randn((b, h, h, padded or c), generator=g, device="cuda").to(
                torch.bfloat16)[..., :c]
            bias = torch.randn(c, generator=g, device="cuda") * 0.5
            got, want = bias_leaky_nhwc(x, bias), bias_leaky_nhwc_plain(x, bias)
            err = max(err, float((got.float() - want.float()).abs().max()))
            if not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"bias_leaky_nhwc {layer} {tuple(x.shape)}: not "
                                     f"bit-identical to bias_leaky (max abs diff {err:.4g})")
            del got, want
            t_plain, t_kernel = in_turns(lambda: bias_leaky_nhwc_plain(x, bias),
                                         lambda: bias_leaky_nhwc(x, bias))
            calls = 4 if nbytes(x) > 2**30 else 20
            device_us = graph_us(lambda: bias_leaky_nhwc(x, bias), calls)
            moved = 2 * nbytes(x) + nbytes(bias)
            bound = Bound().add(moved, {"f32": 3 * x.numel()})
            share = bound.total * 1e3 / device_us
            result[(layer, b)] = {"ms": t_kernel, "device_us": device_us, "plain_ms": t_plain,
                                  "library_ms": None, "bound_ms": bound.total,
                                  "bound_by": bound.by, "share": share}
            of = f" (of {padded} channels)" if padded else ""
            log(f"[time] {card} | bias_leaky_nhwc {layer} {tuple(x.shape)} bf16{of}: "
                "bit-identical to bias_leaky; kernel "
                f"{t_kernel:.4f} ms, device {device_us:.1f} us a call in a graph of {calls} = "
                f"{moved / 1e3 / device_us:.0f} GB/s, {100 * share:.1f} % of its bound "
                f"{bound.total:.4f} ms ({bound.by}); plain (bias_leaky) {t_plain:.4f} ms "
                "(median of 8 / 8); no PyTorch call computes it in one pass")
            if b == TIME_BATCHES[-1] and share < EPILOGUE_TARGETS[layer]:
                short.append(f"{layer} at batch {b}: {100 * share:.1f} % < "
                             f"{100 * EPILOGUE_TARGETS[layer]:.0f} %")
    if short:
        raise AssertionError(f"bias_leaky_nhwc below its target share of the bound: {short}")
    return result, err


def host_split(card: str) -> dict:
    """Where a kernel wrapper's host time goes: each part of a maxpool2x2
    call at Tiny's batch-8 pool4 shape, (8, 52, 52, 128) bf16, timed alone
    with ``time.perf_counter_ns``, the median of HOST_ROUNDS rounds of
    HOST_CALLS calls (a round's mean picks up the host's hiccups), beside
    the whole wrapper, the engine's call with its permutes and
    ``F.max_pool2d``; then the fused decode+NMS wrapper on a batch-8 bf16
    head and its ``Kernel`` call alone.  The device context and the
    ``torch.cuda.Stream`` lookup are the parts the first launch path paid on
    every call; the current device index, the raw stream handle and
    ``new_empty`` are what ``_build.Kernel`` and the wrappers use instead."""

    import torch.nn.functional as F

    from yolojax_torch.kernels import _build, pool
    from yolojax_torch.kernels import postprocess_fused as pf
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused

    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((8, 52, 52, 128))
                         .astype(np.float32)).to("cuda", torch.bfloat16)
    raw = torch.from_numpy(seeded_raw(rng, 8, 13, 13, 5, 20, "bench")).to("cuda", torch.bfloat16)
    anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (5, 2)).astype(np.float32)).cuda()
    out = postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, TOPK)
    group, smem = pf.layout(845, 20, 8, torch.cuda.get_device_properties(0).multi_processor_count)
    fused_args = (raw.data_ptr(), anchors.data_ptr(), *(t.data_ptr() for t in out), 8, 13, 13, 5,
                  20, group, smem, THRESHOLD, OVERLAP, TOPK, 1)
    bias = torch.from_numpy(rng.normal(0, 0.5, 128).astype(np.float32)).cuda()
    xc = x.permute(0, 3, 1, 2)
    y = pool.maxpool2x2(x)
    shape, dev = tuple(y.shape), x.device
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib = _build.load(pool.SOURCE, {"yolo_maxpool2x2": [ptr, ptr, ptr, ptr, *[i32] * 6, ptr]})
    stream = torch.cuda.current_stream(dev).cuda_stream
    xp, yp = x.data_ptr(), y.data_ptr()
    raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    get_device = getattr(torch._C, "_cuda_getDevice", None)

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {
        "device context, enter and exit": context,
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev)
        .cuda_stream,
        "_build.load(source) lookup": lambda: _build.load(pool.SOURCE, {}),
        "current device index": get_device,
        "raw stream handle": (lambda: raw_stream(0)) if raw_stream else None,
        "_check(x)": lambda: pool._check(x),
        "torch.empty(out)": lambda: torch.empty(shape, dtype=x.dtype, device=dev),
        "x.new_empty(out)": lambda: x.new_empty(shape),
        "data_ptr() of x and out": lambda: (x.data_ptr(), y.data_ptr()),
        "ctypes call with its launch": lambda: lib.yolo_maxpool2x2(xp, None, yp, None, 8, 52,
                                                                   52, 128, 1, 1, stream),
        "Kernel call: lookups, ctypes call, launch, error check": lambda: pool._KERNEL(
            x, xp, None, yp, None, 8, 52, 52, 128, 1, 1),
        "the engine's two permutes": lambda: xc.permute(0, 2, 3, 1).permute(0, 3, 1, 2),
        "maxpool2x2(x), the whole wrapper": lambda: pool.maxpool2x2(x),
        "maxpool2x2(x, bias), the fused wrapper": lambda: pool.maxpool2x2(x, bias),
        "the engine's call, permutes and wrapper": lambda: pool.maxpool2x2(
            xc.permute(0, 2, 3, 1)).permute(0, 3, 1, 2),
        "F.max_pool2d(x_nchw, 2, 2)": lambda: F.max_pool2d(xc, 2, 2),
        "postprocess_fused, the whole wrapper (B=8 bf16 head)": lambda: postprocess_fused(
            raw, anchors, THRESHOLD, OVERLAP, TOPK),
        "postprocess_fused's Kernel call alone": lambda: pf._KERNEL(raw, *fused_args),
    }
    result = {}
    for what, fn in parts.items():
        if fn is None:
            log(f"[host] {what}: not in this torch")
            continue
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        rounds = []
        for _ in range(HOST_ROUNDS):
            t0 = time.perf_counter_ns()
            for _ in range(HOST_CALLS):
                fn()
            rounds.append((time.perf_counter_ns() - t0) / HOST_CALLS / 1e3)
            torch.cuda.synchronize()
        result[what] = float(np.median(rounds))
        log(f"[host] {card} | {what}: {result[what]:.2f} us per call (median of {HOST_ROUNDS} "
            f"rounds of {HOST_CALLS}; rounds {min(rounds):.2f}-{max(rounds):.2f})")
    return result


# --profile's paths: (config, the forward kernels' tokens the second run, the plain
# path, drops; it also runs bias_leaky in place of the one-pass epilogue)
PROFILE_PATHS = {"mobilenet": (lambda: mobilenet_config(), DW_TOKENS),
                 "darknet-s2d": (lambda: s2d_config(), {"pool", "reorg"}),
                 "tiny": (lambda: tiny_config(), {"pool"}),
                 "darknet": (lambda: darknet_config(), set())}


def profile(card: str, path: str) -> None:
    """torch.profiler over 5 detect calls of ``path`` at batch 128, with its
    forward kernels and on its plain path: device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.models.inference import Inference

    config_fn, drop = PROFILE_PATHS[path]
    config = config_fn()
    _, _, model = build(config)
    params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
    params["out"]["b"].view(-1, 5 + model.num_classes)[:, 4] = BENCH_OBJECTNESS
    folded = model.fold(params, state)
    x = seeded_images(3, 128)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):  # start-up
        Inference(model).detect_fn(THRESHOLD, OVERLAP, TOPK)(folded, x)
        torch.cuda.synchronize()
    runs = [(" ".join(sorted(model.pallas)), Inference(model).detect_fn(THRESHOLD, OVERLAP, TOPK)),
            (f"without {plain_label(drop)}",
             plain(Inference(without(model, drop)).detect_fn(THRESHOLD, OVERLAP, TOPK)))]
    for what, run in runs:
        for _ in range(3):
            run(folded, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                run(folded, x)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5 * 1e3
        # device kernels only: an aten op's row repeats its kernels' device time
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels) / 5
        if device_us <= 0:
            raise AssertionError("torch.profiler recorded no device time; time with CUDA "
                                 "events instead")
        log(f"[profile] {card} | {path} detect batch 128 at {SIZE}, {what}: "
            f"{device_us / 1e3:.3f} ms of device time per call, {wall:.3f} ms wall under the "
            f"profiler, {sum(e.count for e in kernels) / 5:.0f} kernel launches per call")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:16]:
            share = 100 * e.self_device_time_total / 5 / device_us
            log(f"[profile]   {share:6.2f} %  {e.self_device_time_total / 5 / 1e3:8.3f} ms  "
                f"x{e.count / 5:<5.0f} {e.key[:100]}")


def fused_routing(model, folded, what: str, drop: set) -> None:
    """One batch-8 forward: the path launches the pool and reorg kernels its
    route gives, each in its fused (bias) instantiation (a CUDA graph capture
    of the forward, ``captured_work``), and the forward must call no
    ``aten::cat`` (``torch.profiler``'s host-side ops); prints the device
    kernels per forward with the path's kernels and on the plain path
    (without ``drop``, ``bias_leaky`` for the one-pass epilogue)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    forward = launches_of(model, post=False)
    pools, reorgs = forward["maxpool2x2"], forward["reorg_s2d"]
    x = seeded_images(4, 8)
    counts = {}
    for label, m, epilogue in (("with", model, contextlib.nullcontext()),
                               ("without", without(model, drop), plain_epilogue())):
        with epilogue, torch.inference_mode():
            m.apply_folded(folded, x)
            device = captured_work(lambda: m.apply_folded(folded, x))
            with torch_profile(activities=[ProfilerActivity.CPU]) as prof:
                m.apply_folded(folded, x)
        others = [n for n in device if n.startswith("<")]
        counts[label] = f"{len(device) - len(others)} kernels" + (
            f" + {len(others)} {'/'.join(sorted(set(others)))} nodes" if others else "")
        if label == "without":
            break
        # the template's bool kBias: "true" demangled, "Lb1E" mangled
        fused = lambda n: "true" in n or "Lb1E" in n
        got = {"maxpool2x2": [n for n in device if "maxpool2x2_kernel" in n],
               "reorg_s2d": [n for n in device if "reorg_s2d_kernel" in n]}
        cats = sum(e.name == "aten::cat" for e in prof.events())
        if (len(got["maxpool2x2"]) != pools or len(got["reorg_s2d"]) != reorgs
                or not all(fused(n) for names in got.values() for n in names) or cats):
            raise AssertionError(f"{what}: one forward ran {got} and {cats} aten::cat; expected "
                                 f"{pools} fused pools, {reorgs} fused reorgs and no cat")
    log(f"[{what}] one batch-8 forward: {pools} maxpool2x2 and {reorgs} reorg_s2d launches, "
        f"all with the conv's epilogue, no aten::cat; {counts['with']} per forward in a "
        f"graph capture ({counts['without']} on the plain path: without "
        f"{plain_label(drop)})")


def cuda_tests() -> None:
    """The ``cuda``-marked tests, ``tests/test_torch_cuda_*.py``, on this card
    in a child pytest (``--noconftest``: the tests' conftest sets JAX up for
    the CPU tests).  Every test must pass; none may skip."""
    files = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "tests").glob("test_torch_cuda_*.py"))
    if not files:
        raise AssertionError("no tests/test_torch_cuda_*.py in this checkout")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pytest", "-m", "cuda", "--noconftest", "-p",
                           "no:cacheprovider", "-q", *files], cwd=ROOT, capture_output=True,
                          text=True, timeout=900, check=False)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ""
    if proc.returncode != 0 or "passed" not in summary or any(
            word in summary for word in ("failed", "skipped", "error")):
        log("\n".join(lines[-60:] + proc.stderr.strip().splitlines()[-20:]))
        raise AssertionError(f"pytest -m cuda exited {proc.returncode}: {summary}")
    log(f"[cuda tests] {' '.join(files)}: {summary} (one pytest, "
        f"{time.perf_counter() - t0:.1f} s)")


# -- the train phase ------------------------------------------------------------

TRAIN_ROOT = ROOT / "build" / "chip_smoke_train"   # git-ignored: config root of the train phase
TRAIN_DEVICE = "cuda"       # the card (a CPU rehearsal of the phase sets "cpu")
TRAIN_IMAGES = 64
TRAIN_STEPS = 12
TRAIN_INTERVAL = 4          # multi-scale redraw every 4 steps: sizes 576, 512, 480 from seed 0
TRAIN_RESUME_STEPS = 2
TRAIN_BATCHES = (16, 64)    # timed at 416 in bf16, the config's batch size and 4x it
TRAIN_TIMED_STEPS = 10
# card against CPU, one step of full-width Darknet-19 at 160², B=2 (TF32 off): components
# and grad_norm rtol; params' change, BN state: ‖diff‖ / ‖CPU's‖ over the model.  BN's
# backward over 2 images amplifies f32 rounding: each device's f32 step lies 1e-3 to 1e-2
# from the f64 step, on which both devices agree far closer (the phase prints all three),
# so f32 is held loosely and f64 tightly
TRAIN_PARITY = {torch.float32: {"components": 2e-4, "change": 2e-2, "state": 1e-5},
                torch.float64: {"components": 1e-6, "change": 1e-6, "state": 1e-9}}
# device-kernel name fragments -> class, for the train step's profile
KERNEL_CLASSES = (("conv (cuDNN / GEMM)", ("conv", "gemm", "xmma", "cutlass", "sm90", "wgrad",
                                         "dgrad", "implicit", "winograd", "fft")),
                  ("max pool", ("max_pool",)),
                  ("reduction (BN statistics, loss sums)", ("reduce", "welford", "norm")),
                  ("elementwise (BN, leaky, casts, optimizer)", ("elementwise", "vectorized",
                                                                 "unrolled", "copy", "foreach")))


def synth_records(n: int = TRAIN_IMAGES, seed: int = 20):
    """``n`` seeded images of 200-500 px with 1-5 filled rectangles on a flat
    background each, and their records (boxes normalized, VOC classes)."""
    from yolojax_torch.data.cache import make_record

    rng = np.random.default_rng(seed)
    images, records = {}, []
    for i in range(n):
        h, w = (int(v) for v in rng.integers(200, 501, 2))
        img = np.empty((h, w, 3), np.uint8)
        img[:] = rng.integers(0, 256, 3, dtype=np.uint8)
        k = int(rng.integers(1, 6))
        lo = rng.uniform(0.0, 0.7, (k, 2))
        hi = np.minimum(lo + rng.uniform(0.1, 0.5, (k, 2)), 1.0)
        for (y0, x0), (y1, x1) in zip((lo * (h, w)).astype(int), (hi * (h, w)).astype(int)):
            img[y0:y1, x0:x1] = rng.integers(0, 256, 3, dtype=np.uint8)
        path = f"synth/{i:03d}"
        images[path] = img
        records.append(make_record(path, lo, hi, rng.integers(0, 20, k)))
    return images, records


def train_args(*argv):
    """The train CLI's arguments and config: ``config.ini`` (Darknet-19, VOC,
    bf16, batch 16, canvas 672, 60 boxes, multi-scale 320-608) under
    TRAIN_ROOT, every summary scalar kept, no histogram or image, and the
    gradient clipped at global norm 5, as the repo's end-to-end tests clip:
    config.ini's recipe has no burn-in, and from a random init its loss
    diverges within a few steps in both packages (seen on the CPU)."""
    from yolojax_torch.cli.train import train_parser
    from yolojax_torch.config import load_config

    args = train_parser().parse_args([
        "--device", TRAIN_DEVICE, "-m", f"config/root={TRAIN_ROOT}", "model/name=smoke",
        "train/clip=5",
        f"train/multi_scale_interval={TRAIN_INTERVAL}", "summary/scalar=1",
        "summary/histogram=0", "summary/image=0", "save/interval=1e9", *argv])
    return args, load_config(args.config, args.modify or ())


def write_train_cache(records) -> None:
    import pickle
    import shutil

    from yolojax_torch.data.cache import cache_path

    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)
    _, config = train_args()
    path = Path(cache_path(config, "train"))
    path.parent.mkdir(parents=True)
    with open(path, "wb") as f:
        pickle.dump(records, f)


def train_runs(images) -> dict:
    """TRAIN_STEPS steps of the train CLI's loop from a fresh init, then ``-r``
    for TRAIN_RESUME_STEPS more; returns what the checks need."""
    from yolojax_torch.cli.train import Train
    from yolojax_torch.config import get_model_dir

    args, config = train_args("--steps", str(TRAIN_STEPS))
    train = Train(args, config, imread=images.__getitem__)
    start = {k: {n: v.clone() for n, v in lp.items()} for k, lp in train.params.items()}
    start_state = {n: v.clone() for n, v in train.state["c1"].items()}
    t0 = time.perf_counter()
    if train(max_steps=args.steps) != TRAIN_STEPS:
        raise AssertionError(f"train: stopped at step {train.step}, not {TRAIN_STEPS}")
    first_s = time.perf_counter() - t0
    model_dir = Path(get_model_dir(config))
    rows = [json.loads(line) for line in (model_dir / "scalars.jsonl").read_text().splitlines()]
    sizes = sorted({int(r["size"]) for r in rows})
    bad = [(r["step"], k) for r in rows for k in ("coord", "object", "noobject", "cls", "prior",
                                                  "total", "grad_norm") if not np.isfinite(r[k])]
    if len(rows) != TRAIN_STEPS or bad:
        raise AssertionError(f"train: {len(rows)} scalar rows, non-finite {bad}")
    if len(sizes) < 3:
        raise AssertionError(f"train: input sizes {sizes}; the phase needs 3 or more")
    unchanged = [k for k in start if torch.equal(start[k]["w"], train.params[k]["w"])]
    if unchanged or any(torch.equal(start_state[n], train.state["c1"][n]) for n in start_state):
        raise AssertionError(f"train: params of {unchanged} or c1's BN state did not change")
    if train.opt_state["count"] != TRAIN_STEPS:
        raise AssertionError(f"train: optimizer count {train.opt_state['count']}")
    log(f"[train] {TRAIN_STEPS} steps of Darknet-19 (bf16, batch {train.batch_size}) through "
        f"the loader and the augmentation in {first_s:.1f} s, prewarm of "
        f"{len(train.sizes)} sizes included; input sizes {sizes}; first total "
        f"{rows[0]['total']:.4g}, last {rows[-1]['total']:.4g}; every parameter and c1's "
        f"running mean and variance changed; optimizer count {TRAIN_STEPS}")
    del train

    total = TRAIN_STEPS + TRAIN_RESUME_STEPS
    args, config = train_args("-r", "--steps", str(total), "-m", "train/prewarm=0")
    train = Train(args, config, imread=images.__getitem__)
    seen = train.batch_size * TRAIN_STEPS
    if (train.step, train.seen, train.opt_state["count"]) != (TRAIN_STEPS, seen, TRAIN_STEPS):
        raise AssertionError(f"train -r: resumed at step {train.step}, seen {train.seen}, "
                             f"count {train.opt_state['count']}")
    if train(max_steps=args.steps) != total or train.opt_state["count"] != total:
        raise AssertionError(f"train -r: ended at step {train.step}")
    log(f"[train] -r resumed at step {TRAIN_STEPS}, seen {seen}, with the saved "
        f"optimizer state, and went on to step {total}")
    return {"steps": total, "sizes": sizes, "first_total": rows[0]["total"],
            "last_total": rows[-1]["total"], "final": str(model_dir / f"{total}.npz"),
            "config": config}


def trained_detect(run: dict) -> dict:
    """The final checkpoint through load_weights_auto -> fold -> detect_fn on 3
    batches of 8 at 416: one fused decode+NMS launch per batch, counted."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.models.inference import Inference

    config = run["config"]
    _, _, model = build(config)
    params, state, meta = load_weights_auto(config, model, run["final"], device=TRAIN_DEVICE)
    if meta.get("step") != run["steps"]:
        raise AssertionError(f"detect: {run['final']} holds step {meta.get('step')}")
    inference = Inference(model)
    folded = inference.fold(params, state)
    detect = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
    batches = [seeded_images(30 + i, 8) for i in range(3)]
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    outs = [detect(folded, x) for x in batches]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = launches_of(model, len(batches))
    if launches != want:
        raise AssertionError(f"detect on the trained checkpoint launched {launches}, "
                             f"expected {want}")
    if not all(bool(torch.isfinite(t).all()) for out in outs for t in (out.yx_min, out.conf)):
        raise AssertionError("detect on the trained checkpoint: non-finite outputs")
    picks = sum(int(out.keep.sum()) for out in outs)
    log(f"[train] the final checkpoint ({Path(run['final']).name}) through load_weights_auto, "
        f"fold and detect_fn: {len(batches)} batches, launches {launches}, {picks} picks")
    return launches


def tree_rel(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want‖ over every leaf (want on the CPU)."""
    diff = sum(float(((got[k][n].cpu().double() - v.double()) ** 2).sum())
               for k, lp in want.items() for n, v in lp.items())
    norm = sum(float((v.double() ** 2).sum()) for lp in want.values() for v in lp.values())
    return (diff / norm) ** 0.5


def card_vs_cpu_step() -> dict:
    """One step of full-width Darknet-19 at 160², B=2, no augmentation, TF32
    off, on the card and on the CPU from the same params and batch, in f32
    and in f64 (the loss itself computes in f32)."""
    from yolojax_torch.cli.common import build
    from yolojax_torch.ops.loss import LossConfig
    from yolojax_torch.parallel.mesh import loss_weights_from_config, make_train_step
    from yolojax_torch.utils.train import build_optimizer

    _, config = train_args("-m", "model/dtype=float32")
    _, _, model32 = build(config)
    optimizer = build_optimizer(config)
    rng = np.random.default_rng(40)
    center = rng.uniform(0.3, 0.7, (2, 6, 2))
    half = rng.uniform(0.05, 0.25, (2, 6, 2))
    batch = {"images": torch.from_numpy(rng.uniform(0, 1, (2, 160, 160, 3)).astype(np.float32)),
             "yx_min": torch.from_numpy(np.clip(center - half, 0, 1).astype(np.float32)),
             "yx_max": torch.from_numpy(np.clip(center + half, 0, 1).astype(np.float32)),
             "cls": torch.from_numpy(rng.integers(0, 20, (2, 6)).astype(np.int32)),
             "valid": torch.ones((2, 6), dtype=torch.bool)}
    out = {}
    for dtype, bounds in TRAIN_PARITY.items():
        model = dataclasses.replace(model32, dtype=dtype)
        params, state = model.init(torch.Generator().manual_seed(0))
        on = lambda tree, dev: {k: {n: v.to(dev, dtype) for n, v in lp.items()}
                                for k, lp in tree.items()}
        params = on(params, "cpu")
        step = make_train_step(model, optimizer, loss_weights_from_config(config), LossConfig())
        results = {}
        for dev in ("cpu", TRAIN_DEVICE):
            results[dev] = step(on(params, dev), on(state, dev), optimizer.init(on(params, dev)),
                                {k: v.to(dev) for k, v in batch.items()}, 0)
        (cp, cs, _, cm), (gp, gs, _, gm) = results["cpu"], results[TRAIN_DEVICE]
        worst = max(abs(gm[k].item() - cm[k].item()) / abs(cm[k].item())
                    for k in ("coord", "object", "noobject", "cls", "prior", "total", "grad_norm"))
        change = lambda tree: {k: {n: v.cpu() - params[k][n] for n, v in lp.items()}
                               for k, lp in tree.items()}
        errs = {"components": worst, "change": tree_rel(change(gp), change(cp)),
                "state": tree_rel(gs, cs)}
        name = str(dtype).split(".")[-1]
        out[name] = errs
        out[f"{name}_change"] = {"cpu": change(cp), "card": change(gp)}
        log(f"[train] one {name} step of full-width Darknet-19 at 160², B=2, card against CPU "
            f"(TF32 off): components and grad_norm max rel diff {worst:.3g}, params' change "
            f"{errs['change']:.3g}, BN state {errs['state']:.3g} (bounds {bounds})")
        if any(errs[k] > bounds[k] for k in errs):
            raise AssertionError(f"train: the card's {name} step differs from the CPU's: {errs}")
    exact = out.pop("float64_change")["card"]
    f32 = out.pop("float32_change")
    out["float32_vs_float64"] = {dev: tree_rel(f32[dev], exact) for dev in f32}
    log(f"[train] the f32 params' change against the card's f64 one: CPU "
        f"{out['float32_vs_float64']['cpu']:.3g}, card {out['float32_vs_float64']['card']:.3g}")
    return out


def train_timer(b: int):
    """The model, a step at 416 in bf16 on a device-resident augmented batch
    of ``b``, and the state it runs on."""
    from yolojax_torch.cli.common import build
    from yolojax_torch.config import get_canvas
    from yolojax_torch.data.transform import TrainAugment
    from yolojax_torch.ops.loss import LossConfig
    from yolojax_torch.parallel.mesh import loss_weights_from_config, make_train_step
    from yolojax_torch.utils.train import build_optimizer

    _, config = train_args()
    _, _, model = build(config)
    params, state = model.init(torch.Generator().manual_seed(0), TRAIN_DEVICE)
    optimizer = build_optimizer(config)
    augment = TrainAugment.from_config(config)
    step = make_train_step(model, optimizer, loss_weights_from_config(config), LossConfig(),
                           augment=augment)
    rng = np.random.default_rng(50)
    c, g = get_canvas(config), config.getint("data", "max_boxes")
    center = rng.uniform(0.2, 0.8, (b, g, 2))
    half = rng.uniform(0.02, 0.2, (b, g, 2))
    batch = {"canvas": torch.from_numpy(rng.integers(0, 256, (b, c, c, 3), dtype=np.uint8)),
             "hw": torch.from_numpy(rng.integers(c // 3, c + 1, (b, 2)).astype(np.float32)),
             "yx_min": torch.from_numpy(np.clip(center - half, 0, 1).astype(np.float32)),
             "yx_max": torch.from_numpy(np.clip(center + half, 0, 1).astype(np.float32)),
             "cls": torch.from_numpy(rng.integers(0, 20, (b, g)).astype(np.int32)),
             "valid": torch.from_numpy(rng.uniform(size=(b, g)) < 0.1)}
    batch = {k: v.to(TRAIN_DEVICE) for k, v in batch.items()}
    draws = augment.draw(torch.Generator().manual_seed(1), b)
    return model, optimizer, augment, step, [params, state, optimizer.init(params)], batch, draws


def step_ms(step, carry, batch, draws, reps: int) -> list[float]:
    """Wall ms of ``reps`` steps, each ended by a synchronize (the step reads
    nothing back before it returns)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        carry[:3] = step(*carry, batch, 0, draws, SIZE)[:3]
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def train_times(images, card: str) -> dict:
    """Median ms per step and images/s at 416 in bf16: B=16 and B=64 on a
    device-resident batch, B=16 through the loader; peak memory; the B=16
    step's device time by kernel class (torch.profiler)."""
    from yolojax_torch.cli.train import Train

    out = {}
    for b in TRAIN_BATCHES:
        model, optimizer, augment, step, carry, batch, draws = train_timer(b)
        step_ms(step, carry, batch, draws, 3)
        torch.cuda.reset_peak_memory_stats()
        t = step_ms(step, carry, batch, draws, TRAIN_TIMED_STEPS)
        ms = float(np.median(t))
        out[f"step_ms_b{b}"] = ms
        out[f"img_per_s_b{b}"] = b / ms * 1e3
        out[f"peak_gb_b{b}"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[train] {card} | step at {SIZE}, bf16, batch {b}, device-resident batch: "
            f"median {ms:.2f} ms ({min(t):.2f}-{max(t):.2f}) = {b / ms * 1e3:.1f} img/s; "
            f"peak memory {out[f'peak_gb_b{b}']:.2f} GB")
        if b != TRAIN_BATCHES[0]:
            del model, optimizer, augment, step, carry, batch, draws
            continue
        out["profile"] = train_profile(step, carry, batch, draws, card)
        out["phases"] = train_phases(model, optimizer, augment, carry, batch, draws, card)
        del model, optimizer, augment, step, carry, batch, draws

    args, config = train_args("-m", f"train/multi_scale_min={SIZE}",
                              f"train/multi_scale_max={SIZE}", "model/name=timed",
                              "train/prewarm=0")
    train = Train(args, config, imread=images.__getitem__)
    source = train.device_batches()
    times = []
    for i in range(3 + TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        batch = next(source)
        train.params, train.state, train.opt_state, _ = train.train_step(
            train.params, train.state, train.opt_state, batch, 0, train.draws(train.batch_size),
            SIZE)
        train.step += 1
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    train.summary.close()
    ms = float(np.median(times[3:]))
    out["loader_step_ms_b16"] = ms
    out["loader_img_per_s_b16"] = train.batch_size / ms * 1e3
    log(f"[train] {card} | step at {SIZE}, bf16, batch {train.batch_size}, through the loader "
        f"(threads decode, side-stream copies): median {ms:.2f} ms "
        f"({min(times[3:]):.2f}-{max(times[3:]):.2f}) = {out['loader_img_per_s_b16']:.1f} img/s")
    return out


def train_profile(step, carry, batch, draws, card: str) -> dict:
    """torch.profiler over 3 steps at batch 16: device time by kernel class
    and the top kernels.  The profiler drops device events on some H100
    machines (it kept none of one call's in one run): where it recorded none
    in PROFILE_TRIES tries, the profile is "not measured" (None)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(PROFILE_TRIES):
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_ms(step, carry, batch, draws, 3)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in kernels) / 3
        if device_us > 0:
            break
    else:
        log(f"[profile] torch.profiler recorded no device time for the train step in "
            f"{PROFILE_TRIES} tries: not measured")
        return {"device_ms": None, "launches": None, "shares": None}
    shares = {}
    for e in kernels:
        name = e.key.lower()
        cls = next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")
        shares[cls] = shares.get(cls, 0.0) + e.self_device_time_total / 3 / device_us
    launches = sum(e.count for e in kernels) / 3
    log(f"[profile] {card} | train step at {SIZE}, bf16, batch 16: {device_us / 1e3:.3f} ms of "
        f"device time per step, {launches:.0f} kernel launches per step")
    for cls, share in sorted(shares.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {100 * share:6.2f} %  {cls}")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:20]:
        log(f"[profile]   {100 * e.self_device_time_total / 3 / device_us:6.2f} %  "
            f"{e.self_device_time_total / 3 / 1e3:8.3f} ms  x{e.count / 3:<5.0f} {e.key[:90]}")
    return {"device_ms": device_us / 1e3, "launches": launches,
            "shares": {k: round(v, 4) for k, v in shares.items()}}


def train_phases(model, optimizer, augment, carry, batch, draws, card: str) -> dict:
    """CUDA-event ms of the step's parts at batch 16, each run alone:
    augment, forward, forward + loss + backward, optimizer update."""
    from yolojax_torch.ops.loss import LossConfig, region_loss

    params, state, opt_state = carry
    anchors = torch.as_tensor(model.anchors, device=TRAIN_DEVICE)
    images, ymin, ymax, valid = augment.apply(batch["canvas"], batch["hw"], batch["yx_min"],
                                              batch["yx_max"], batch["valid"], draws, SIZE)

    def backward():
        live = {k: {n: v.detach().requires_grad_(True) for n, v in lp.items()}
                for k, lp in params.items()}
        raw, _ = model.apply(live, state, images, train=True)
        comps = region_loss(raw, anchors, ymin, ymax, batch["cls"], valid, 0, LossConfig())
        sum(comps.values()).backward()

    grads = {k: {n: torch.ones_like(v) for n, v in lp.items()} for k, lp in params.items()}
    parts = {"augment": lambda: augment.apply(batch["canvas"], batch["hw"], batch["yx_min"],
                                              batch["yx_max"], batch["valid"], draws, SIZE),
             "forward": lambda: model.apply(params, state, images, train=True),
             "forward+loss+backward": backward,
             "optimizer": lambda: optimizer.step(grads, opt_state, params)}
    out = {name: float(np.median(cuda_ms(fn, 5, 2))) for name, fn in parts.items()}
    log(f"[train] {card} | parts of the batch-{TRAIN_BATCHES[0]} step at {SIZE} (CUDA events, each alone): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in out.items()))
    return out


def train_phase(card: str) -> tuple[dict, dict, str]:
    """The train CLI's loop on synthetic records, resume, detect on its
    checkpoint, the card against the CPU, and times.  Returns (the fused
    kernel's launches on the trained checkpoint, the train line's numbers,
    the final checkpoint's path)."""
    t0 = time.perf_counter()
    images, records = synth_records()
    write_train_cache(records)
    run = train_runs(images)
    launches = trained_detect(run)
    parity = card_vs_cpu_step()
    times = train_times(images, card)
    result = {"card": card, "model": "Darknet-19", "dtype": "bfloat16", "size": SIZE,
              "steps": run["steps"], "sizes": run["sizes"], "first_total": run["first_total"],
              "last_total": run["last_total"], "card_vs_cpu": parity, **times,
              "seconds": time.perf_counter() - t0}
    log(f"[train] the train phase took {result['seconds']:.1f} s")
    return launches, result, run["final"]


# -- the eval phase -------------------------------------------------------------

EVAL_DIR = ROOT / "build" / "chip_smoke_eval"   # git-ignored: the VOC layout and the stub
EVAL_IMAGES = 48
# card against CPU, the whole eval in f32 with TF32 off: mAP and each class's AP, absolute
EVAL_PARITY = {"map": 2e-3, "ap": 1e-2}
# a stand-in for cv2 where OpenCV is not installed (the chip machine has none): imread of
# the binary PPM files the phase writes, which cv2 itself decodes by content too.  The
# in-process runs read through it, and the eval CLI's child process imports it as cv2
CV2_STUB = '''"""cv2 stand-in: imread of binary PPM (P6) files only."""
import numpy as np

IMREAD_COLOR = 1


def imread(path, flags=IMREAD_COLOR):
    with open(path, "rb") as f:
        magic, size, maxval, pixels = f.read().split(b"\\n", 3)
    if magic != b"P6" or maxval != b"255":
        return None
    w, h = (int(v) for v in size.split())
    return np.frombuffer(pixels, np.uint8).reshape(h, w, 3)[:, :, ::-1].copy()  # BGR
'''


def eval_config(*mods):
    """config.ini (Darknet-19, VOC, bf16, [eval] threshold 0.005, topk 300,
    batch 16) with the train phase's root and model name, so its checkpoints
    are the model dir's, and the phase's VOC root."""
    from yolojax_torch.config import load_config

    return load_config(None, [f"config/root={TRAIN_ROOT}", "model/name=smoke",
                              f"cache/voc_roots={EVAL_DIR / 'VOC2007'}", *mods])


def eval_workspace():
    """EVAL_IMAGES seeded images (synth_records) in VOC2007's layout, images
    as binary PPM, one box in ten difficult; the test cache built from it by
    the port's builder through ``[cache] datasets = yolojax.data.voc``.
    Returns (the cv2 stand-in's directory, its imread in RGB, the records)."""
    import importlib.util
    import shutil

    from yolojax_torch.category import get_category
    from yolojax_torch.config import get_cache_dir
    from yolojax_torch.data.cache import cache

    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    voc = EVAL_DIR / "VOC2007"
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        (voc / sub).mkdir(parents=True)
    stub = EVAL_DIR / "stub"
    stub.mkdir()
    (stub / "cv2.py").write_text(CV2_STUB)
    spec = importlib.util.spec_from_file_location("chip_smoke_cv2_stub", stub / "cv2.py")
    cv2_stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cv2_stub)

    config = eval_config()
    names = get_category(config)
    rng = np.random.default_rng(61)
    images, records = synth_records(EVAL_IMAGES, seed=60)
    ids = []
    for i, rec in enumerate(records):
        img = images[rec["path"]]
        h, w = img.shape[:2]
        ids.append(f"{i:06d}")
        (voc / "JPEGImages" / f"{ids[-1]}.jpg").write_bytes(
            f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
        objs = []
        for lo, hi, c in zip(rec["yx_min"], rec["yx_max"], rec["cls"]):
            (y0, x0), (y1, x1) = (lo * (h, w)).astype(int), (hi * (h, w)).astype(int)
            objs.append(f"<object><name>{names[c]}</name><difficult>"
                        f"{int(rng.uniform() < 0.1)}</difficult><bndbox><xmin>{x0 + 1}</xmin>"
                        f"<ymin>{y0 + 1}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox>"
                        "</object>")
        (voc / "Annotations" / f"{ids[-1]}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size>"
            f"{''.join(objs)}</annotation>")
    (voc / "ImageSets" / "Main" / "test.txt").write_text("\n".join(ids))
    built = cache(config, phases=("test",))["test"]
    boxes = sum(len(r["cls"]) for r in built)
    difficult = sum(int(r["difficult"].sum()) for r in built)
    if len(built) != EVAL_IMAGES or not difficult:
        raise AssertionError(f"eval: the cache holds {len(built)} images, {difficult} difficult")
    log(f"[eval] {EVAL_IMAGES} images in VOC2007 layout; cache/test.pkl built by "
        f"yolojax_torch.data.cache.cache through [cache] datasets = "
        f"{config.get('cache', 'datasets')} in {get_cache_dir(config)}: {boxes} boxes, "
        f"{difficult} difficult")
    rgb = lambda path: cv2_stub.imread(path)[:, :, ::-1]
    return stub, rgb, built


def eval_once(config, params, state, records, imread, what: str, expect: dict | None):
    """``cli.eval.run_eval`` at 416, batch 16, with every launch counter set
    to 0 just before and read just after; the counts must be ``expect`` (all
    counters; None on the CPU).  Returns (result, launches, wall seconds)."""
    from yolojax_torch.cli.common import build
    from yolojax_torch.cli.eval import run_eval

    category, _, model = build(config)
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    result = run_eval(config, model, params, state, records, SIZE, EVAL_BATCH, category,
                      imread=imread)
    if expect is not None:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    if expect is not None and launches != expect:
        raise AssertionError(f"eval {what}: launched {launches}, expected {expect}")
    dets = sum(len(d) for d in result["recorder"].dets.values())
    if not (np.isfinite(result["map"]) and 0 <= result["map"] <= 1 and dets):
        raise AssertionError(f"eval {what}: mAP {result['map']}, {dets} detections")
    log(f"[eval] {what}: mAP {result['map']:.6f} over {len(result['ap'])} classes, {dets} "
        f"detections, {len(records)} images in {seconds:.2f} s (Meter: "
        f"{result['rate']:.1f} img/s); launches {launches}")
    return result, launches, seconds


def same_picks(got, want, what: str) -> int:
    """Two recorders' detections, slot by slot: the same images and counts,
    conf rtol 1e-5, corners atol 1e-5.  Returns the count of detections."""
    count = 0
    for c in sorted(set(got.dets) | set(want.dets)):
        a, b = got.dets.get(c, []), want.dets.get(c, [])
        if [d[0] for d in a] != [d[0] for d in b]:
            raise AssertionError(f"{what}: class {c} holds other images or counts "
                                 f"({len(a)} vs {len(b)} detections)")
        for (img, conf, dmin, dmax), (_, wconf, wmin, wmax) in zip(a, b):
            if (abs(conf - wconf) > 1e-5 * abs(wconf)
                    or max(np.abs(dmin - wmin).max(), np.abs(dmax - wmax).max()) > 1e-5):
                raise AssertionError(f"{what}: class {c} image {img} picks another detection "
                                     f"(conf {conf} vs {wconf})")
        count += len(a)
    return count


def eval_child(stub: Path, final: str, npz_map: float) -> dict:
    """``python -m yolojax_torch.cli.eval`` in a child process on the card,
    ``-f`` a ``.weights`` file written by ``tools/darknet.py::save_weights``
    from the same checkpoint: its mAP must equal the npz run's."""
    import importlib.util
    import os

    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.config import get_eval_db
    from yolojax_torch.tools.darknet import save_weights

    config = eval_config()
    _, _, model = build(config)
    params, state, meta = load_weights_auto(config, model, final)
    weights = EVAL_DIR / "smoke.weights"
    save_weights(str(weights), model, params, state, seen=int(meta.get("seen", 0)))
    db, results = Path(get_eval_db(config)), EVAL_DIR / "dets.jsonl"
    db.unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if importlib.util.find_spec("cv2") is None:
        env["PYTHONPATH"] += os.pathsep + str(stub)
    argv = [sys.executable, "-m", "yolojax_torch.cli.eval", "-m", f"config/root={TRAIN_ROOT}",
            "model/name=smoke", f"cache/voc_roots={EVAL_DIR / 'VOC2007'}", "-f", str(weights),
            "--results", str(results)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600,
                          check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"eval CLI exited {proc.returncode}")
    printed = [line for line in proc.stdout.splitlines() if line.startswith("mAP = ")]
    rows = [json.loads(line) for line in db.read_text().splitlines()]
    dets = results.read_text().splitlines()
    if (len(printed) != 1 or len(rows) != 1 or set(rows[0]) != {"time", "size", "map", "ap"}
            or not dets):
        raise AssertionError(f"eval CLI: printed {printed}, {len(rows)} eval.jsonl rows, "
                             f"{len(dets)} result lines")
    if rows[0]["map"] != npz_map or printed[0] != f"mAP = {npz_map:.4f}":
        raise AssertionError(f"eval CLI on {weights.name}: mAP {rows[0]['map']} "
                             f"({printed[0]}), the npz run's {npz_map}")
    log(f"[eval] python -m yolojax_torch.cli.eval -f {weights.name} ({weights.stat().st_size} "
        f"bytes, written by save_weights from {Path(final).name}) in a child process: "
        f"'{printed[0]}', eval.jsonl row {sorted(rows[0])}, {len(dets)} result lines; mAP "
        f"equals the npz run's; {seconds:.1f} s with start-up")
    return {"map": rows[0]["map"], "seconds": seconds, "result_lines": len(dets)}


def trained_heads(config, params, state, records, imread):
    """The trained checkpoint's raw head on the first EVAL_BATCH eval images
    at 416, bf16, as eval computes it."""
    from yolojax_torch.cli.common import build
    from yolojax_torch.config import get_canvas
    from yolojax_torch.data.dataset import Dataset, collate
    from yolojax_torch.data.transform import resize_from_config
    from yolojax_torch.models.inference import Inference

    _, _, model = build(config)
    dataset = Dataset(records[:EVAL_BATCH], canvas=get_canvas(config), imread=imread)
    batch = collate([dataset.load(i) for i in range(len(dataset))])
    images, _, _ = resize_from_config(config)(torch.from_numpy(batch["canvas"]).cuda(),
                                              torch.from_numpy(batch["hw"]).cuda(), SIZE)
    with torch.inference_mode():
        raw = model.apply_folded(Inference(model).fold(params, state), images)
    return raw, torch.as_tensor(model.anchors, device="cuda")


def fused_eval_times(card: str, trained) -> dict:
    """The fused kernel at eval's point (B=16, topk 300, bf16) against its
    plain version, one-call ms in turns and device µs (torch.profiler over 20
    calls), with the bound: the eval geometries at bench and saturated
    densities, and the trained head."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.postprocess import postprocess_raw

    def device_us(fn, calls: int = 20) -> tuple[float, str]:
        """Median device µs of the kernels the profiler recorded over ``calls``
        calls, and what it is: late in a long process the profiler drops some
        device events (seen on the H100), so a sum over the calls would read
        low; where it kept none (seen once on the H100), CUDA events around the
        calls instead, whose mean holds the launch gaps too."""
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "postprocess_fused" in e.name]
        if times:
            return float(np.median(times)), (f"median of the {len(times)} of {calls} calls "
                                             "the profiler recorded")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e3 / calls, (f"CUDA events, mean of {calls} calls: "
                                                       "the profiler recorded none")

    rng = np.random.default_rng(70)
    cases = []
    for b, h, w, a, c in EVAL_GEOMETRIES:
        anchors = torch.from_numpy(rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)).cuda()
        for density in ("bench", "saturated"):
            raw = torch.from_numpy(seeded_raw(rng, b, h, w, a, c, density)).to("cuda",
                                                                              torch.bfloat16)
            cases.append((f"({b},{h},{w},{a * (5 + c)}) {density}", raw, anchors, c))
    raw, anchors = trained
    cases.append((f"{tuple(raw.shape)} trained (14 steps)", raw, anchors, raw.shape[-1] // 5 - 5))
    out = {}
    for what, raw, anchors, c in cases:
        kernel = lambda: postprocess_fused(raw, anchors, THRESHOLD, OVERLAP, EVAL_TOPK)
        t_plain, t_kernel = in_turns(
            lambda: postprocess_raw(raw, anchors, THRESHOLD, OVERLAP, EVAL_TOPK), kernel)
        res = kernel()
        n = raw.shape[1] * raw.shape[2] * anchors.shape[0]
        picks = int(res.keep.sum())
        bound = Bound().add(nbytes(raw, anchors, *res),
                            {"f32": raw.shape[0] * n * (3 * c + 20) + picks * n * 16})
        dev, how = device_us(kernel)
        out[what] = {"ms": t_kernel, "plain_ms": t_plain, "device_us": dev,
                     "bound_ms": bound.total, "bound_by": bound.by, "picks": picks}
        log(f"[time] {card} | fused at eval's point, {what} bf16, topk {EVAL_TOPK}: kernel "
            f"{t_kernel:.4f} ms one-call, {dev:.1f} us device ({how}); plain {t_plain:.4f} "
            f"ms; bound {bound.total:.5f} ms "
            f"by {bound.by}; {picks} picks")
    return out


def eval_phase(card: str, final: str) -> tuple[dict, dict]:
    """Eval on the train phase's checkpoint: the cache builder, run_eval on the
    card in bf16 (the main path), f32 card against CPU, the eval CLI from a
    ``.weights`` file, ``pallas = nms``, the fused kernel on the trained head.
    Returns (launches on the main path and the nms run, the eval line)."""
    from yolojax_torch.cli.common import build, load_weights_auto

    t0 = time.perf_counter()
    stub, imread, records = eval_workspace()
    config = eval_config()
    names, _, model = build(config)
    params, state, meta = load_weights_auto(config, model, final, device="cuda")
    if meta.get("step") != TRAIN_STEPS + TRAIN_RESUME_STEPS:
        raise AssertionError(f"eval: {final} holds step {meta.get('step')}")
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    main, launches, seconds = eval_once(config, params, state, records, imread,
                                        "bf16 on the card (fused decode+NMS)",
                                        launches_of(model, batches))
    log("[eval] AP per class: " + ", ".join(f"{names[c]} {ap:.4f}"
                                            for c, ap in sorted(main["ap"].items())))

    trained = trained_heads(config, params, state, records, imread)
    raw, anchors = trained
    c = raw.shape[-1] // anchors.shape[0] - 5
    fused_err = max(fused_case(raw.to(dtype), anchors, c, f"{tuple(raw.shape)} trained "
                               f"{str(dtype)[6:]} topk {EVAL_TOPK}", EVAL_TOPK)
                    for dtype in (torch.float32, torch.bfloat16))

    nms_cfg = eval_config("model/pallas=nms")
    nms, nms_launches, _ = eval_once(nms_cfg, params, state, records, imread,
                                     "bf16 on the card with pallas = nms (nms_select)",
                                     launches_of(model_of(nms_cfg), batches))
    picks = same_picks(nms["recorder"], main["recorder"], "pallas = nms against fusedpost")
    if nms["map"] != main["map"]:
        raise AssertionError(f"eval: pallas = nms gives mAP {nms['map']}, fusedpost "
                             f"{main['map']}")
    log(f"[eval] pallas = nms picks what fusedpost picks: all {picks} detections, slot by "
        f"slot; the same mAP {nms['map']:.6f}")

    f32 = {}
    for device in ("cuda", "cpu"):
        cfg = eval_config("model/dtype=float32")
        p, s, _ = load_weights_auto(cfg, build(cfg)[2], final, device=device)
        where = "card" if device == "cuda" else "CPU"
        f32[device], _, _ = eval_once(cfg, p, s, records, imread, f"f32 on the {where}",
                                      launches_of(model, batches) if device == "cuda"
                                      else None)
    gap = {"map": abs(f32["cuda"]["map"] - f32["cpu"]["map"]),
           "ap": max(abs(f32["cuda"]["ap"][k] - v) for k, v in f32["cpu"]["ap"].items())}
    log(f"[eval] f32 card against CPU (TF32 off): mAP {f32['cuda']['map']:.6f} vs "
        f"{f32['cpu']['map']:.6f}, gap {gap['map']:.3g}; largest class AP gap {gap['ap']:.3g} "
        f"(bounds {EVAL_PARITY})")
    if f32["cuda"]["ap"].keys() != f32["cpu"]["ap"].keys() or any(
            gap[k] > EVAL_PARITY[k] for k in gap):
        raise AssertionError(f"eval: the card's f32 eval differs from the CPU's: {gap}")

    child = eval_child(stub, final, main["map"])
    times = fused_eval_times(card, trained)
    result = {"card": card, "model": "Darknet-19", "dtype": "bfloat16", "size": SIZE,
              "images": EVAL_IMAGES, "batch": EVAL_BATCH, "topk": EVAL_TOPK,
              "threshold": THRESHOLD, "map": main["map"],
              "ap": {names[k]: v for k, v in main["ap"].items()},
              "img_per_s": EVAL_IMAGES / seconds, "meter_img_per_s": main["rate"],
              "seconds": seconds, "nms_map": nms["map"], "detections": picks,
              "f32_card_map": f32["cuda"]["map"], "f32_cpu_map": f32["cpu"]["map"],
              "f32_card_ap": {names[k]: v for k, v in f32["cuda"]["ap"].items()},
              "f32_gap": gap, "weights_map": child["map"], "fused_trained_err": fused_err,
              "fused_times": times, "phase_seconds": time.perf_counter() - t0}
    log(f"[eval] {card} | eval at {SIZE}, bf16, batch {EVAL_BATCH}: {EVAL_IMAGES} images in "
        f"{seconds:.2f} s = {result['img_per_s']:.1f} img/s (host AP included); the eval "
        f"phase took {result['phase_seconds']:.1f} s")
    return summed(launches, nms_launches), result


# -- the deploy and tools phase ---------------------------------------------------

DEPLOY_DIR = ROOT / "build" / "chip_smoke_deploy"   # git-ignored: programs, pruned checkpoints
DEPLOY_BATCHES = 3
# the four paths the export takes; each program holds a custom-op call for each
# launch of its route at 416
EXPORT_PATHS = {"darknet": darknet_config, "mobilenet": mobilenet_config,
                "darknet-s2d": s2d_config, "tiny": tiny_config}
BASELINE1_ATOL = 1e-4       # BASELINE config 1, CPU against the card in f32: boxes
RF_RTOL = 1e-3              # the effective receptive field, card against CPU in f32
PRUNE_RATIO = 0.3
# replays saved programs in a fresh process; argv[1] is JSON {path: [program, inputs]}
REPLAY = """
import json, sys, torch
import yolojax_torch.kernels.ops
from chip_smoke import bits, launch_counters
out = {}
for path, (program, io) in json.loads(sys.argv[1]).items():
    x, want = torch.load(io)
    replay = torch.export.load(program).module()
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    got = replay(x)
    torch.cuda.synchronize()
    out[path] = {"launches": {k: fn.launches for k, fn in counters.items()},
                 "same_bits": bool(torch.equal(bits(got), bits(want))),
                 "max_abs_err": float((got - want).abs().max())}
print(json.dumps(out))
"""


def deploy_config(*mods):
    """config.ini with the train phase's root and model name (its checkpoints)."""
    from yolojax_torch.config import load_config

    return load_config(None, [f"config/root={TRAIN_ROOT}", "model/name=smoke", *mods])


def zero_counters() -> dict:
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    return counters


def read_counters(counters: dict) -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters.items()}


def same_host_picks(got, want, what: str) -> int:
    """The host path's PostProcessed (CPU) against the fused kernel's (card):
    ``keep`` and, where kept, conf and corners bit for bit; returns the picks.
    On a difference, print the first (image, class) that differs with both
    pick lists and the IoU of the first differing pick with the picks before
    it, then raise."""
    from yolojax_torch.ops.iou import iou_pairwise

    want = type(want)(*(t.cpu() for t in want))
    keep = want.keep
    fields = ((got.conf, want.conf), (got.yx_min, want.yx_min), (got.yx_max, want.yx_max))

    def same(idx):
        k = keep[idx]
        return torch.equal(got.keep[idx], k) and all(
            torch.equal(bits(g[idx][k]), bits(w[idx][k])) for g, w in fields)

    if same(...):
        return int(keep.sum())
    b, c = next(bc for bc in np.ndindex(*keep.shape[:2]) if not same(bc))
    k = int(torch.nonzero((got.keep[b, c] != keep[b, c]) | (got.conf[b, c] != want.conf[b, c])
                          | (got.yx_min[b, c] != want.yx_min[b, c]).any(-1))[0])
    lists = []
    for out in (got, want):
        boxes = torch.cat([out.yx_min[b, c, :k + 1], out.yx_max[b, c, :k + 1]], -1)
        iou = iou_pairwise(boxes[:k, :2], boxes[:k, 2:], boxes[k:, :2], boxes[k:, 2:])
        lists.append(f"keep {out.keep[b, c, :k + 1].tolist()} conf "
                     f"{out.conf[b, c, :k + 1].tolist()} boxes {boxes.tolist()}; IoU of slot "
                     f"{k} with the picks before it {iou.tolist()}")
    log(f"[deploy] {what}: image {b} class {c} differs first at slot {k}: host {lists[0]}; "
        f"fused {lists[1]}")
    raise AssertionError(f"{what}: the host path's picks differ from the fused kernel's")


def host_detect(final: str) -> tuple[dict, dict]:
    """Build the native NMS; on the train phase's checkpoint, ``detect_fn_host``
    (forward on the card, NMS on the host) against ``detect_fn`` (the fused
    kernel) at [detect]'s point and at threshold 0.005; then BASELINE config
    1: ``detect_image`` with the model and image on the CPU in f32 (the host
    path) against the card's.  Returns (launches, numbers for the line)."""
    from yolojax_torch import native
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.detect import detect_image
    from yolojax_torch.models.inference import Inference

    t0 = time.perf_counter()
    lib = native.build()          # raises with g++'s message: no quiet fallback
    if not native.native_nms_available():
        raise AssertionError(f"deploy: {lib} built but does not load")
    log(f"[deploy] native NMS {lib.name} (g++ {' '.join(native.GXX_FLAGS)}; built by the "
        f"cuda tests' child process or here) ready in {time.perf_counter() - t0:.2f} s")
    config = deploy_config()
    _, _, model = build(config)
    params, state, meta = load_weights_auto(config, model, final, device="cuda")
    inference = Inference(model)
    folded = inference.fold(params, state)
    overlap, topk = config.getfloat("detect", "overlap"), config.getint("detect", "topk")
    batches = [seeded_images(70 + i, 8) for i in range(DEPLOY_BATCHES)]
    picks = {}
    counters = zero_counters()
    for threshold in (config.getfloat("detect", "threshold"), THRESHOLD):
        fused = inference.detect_fn(threshold, overlap, topk)
        host = inference.detect_fn_host(threshold, overlap, topk)
        picks[str(threshold)] = sum(same_host_picks(host(folded, x), fused(folded, x),
                                                    f"threshold {threshold} batch {i}")
                                    for i, x in enumerate(batches))
    launches = read_counters(counters)
    # for each of the two thresholds, a batch's fused call and host call (its
    # forward alone on the card)
    calls = 2 * len(batches)
    want = summed(launches_of(model, calls), launches_of(model, calls, post=False))
    if launches != want:
        raise AssertionError(f"deploy: detect_fn and detect_fn_host launched {launches}, "
                             f"expected {want}")
    log(f"[deploy] detect_fn_host (the {meta.get('step')}-step Darknet-19 checkpoint, bf16, "
        f"forward on the card, native NMS on the host) equals detect_fn (the fused kernel) on "
        f"{len(batches)} batches of 8: keep, pick order, conf and corners bit for bit; picks "
        f"by threshold {picks}; launches {launches}")

    # BASELINE config 1.  The 14-step head scores every box under [detect]'s
    # 0.4, so the threshold is set inside the widest gap between the 20th and
    # 60th scores the card detects at 0.005: no score lies near it
    image = synth_records()[0]["synth/000"]        # a train image of the checkpoint
    cfg32 = deploy_config("model/dtype=float32", f"detect/threshold={THRESHOLD}")
    _, _, model32 = build(cfg32)
    p, s, _ = load_weights_auto(cfg32, model32, final, device="cuda")
    confs = np.sort(detect_image(cfg32, model32, p, s, image, SIZE)[3])[::-1]
    k = 20 + int(np.argmax(confs[19:59] - confs[20:60]))
    threshold = float((confs[k - 1] + confs[k]) / 2)
    cfg32.set("detect", "threshold", repr(threshold))
    out = {}
    for device in ("cuda", "cpu"):
        p, s, _ = load_weights_auto(cfg32, model32, final, device=device)
        out[device] = detect_image(cfg32, model32, p, s, image, SIZE)
    cpu_ms = []
    for _ in range(3):
        t = time.perf_counter()
        detect_image(cfg32, model32, p, s, image, SIZE)
        cpu_ms.append((time.perf_counter() - t) * 1e3)
    (cmin, cmax, ccls, cconf), (gmin, gmax, gcls, gconf) = out["cpu"], out["cuda"]
    if not (len(ccls) and np.array_equal(ccls, gcls)):
        raise AssertionError(f"BASELINE config 1: classes differ, CPU {ccls.tolist()} card "
                             f"{gcls.tolist()}")
    box_err = float(max(np.abs(cmin - gmin).max(), np.abs(cmax - gmax).max()))
    if box_err > BASELINE1_ATOL:
        raise AssertionError(f"BASELINE config 1: boxes {box_err:.3g} apart (> {BASELINE1_ATOL})")
    conf_err = float(np.abs(cconf - gconf).max())
    log(f"[deploy] BASELINE config 1 (Darknet-19 at {SIZE}, f32, one {image.shape[0]}x"
        f"{image.shape[1]} image, forward and native NMS on the CPU, threshold "
        f"{threshold:.6g} between scores {confs[k - 1]:.6g} and {confs[k]:.6g}): {len(ccls)} "
        f"detections, the card's classes, boxes within {box_err:.3g}, conf within "
        f"{conf_err:.3g}; CPU detect_image {np.median(cpu_ms):.1f} ms (median of 3, BN fold "
        f"included)")
    return launches, {"host_picks": picks, "baseline1_threshold": threshold,
                      "baseline1_detections": len(ccls),
                      "baseline1_box_err": box_err, "baseline1_conf_err": conf_err,
                      "baseline1_cpu_ms": float(np.median(cpu_ms))}


def export_paths() -> tuple[dict, dict]:
    """Each of the four paths at 416, bf16, B=8, seeded: ``export_program``,
    ``torch.export.save``, the custom-op calls counted in the graph, then
    one child process loads every program (after importing
    ``kernels/ops.py``) and replays it on a seeded batch: bit-identical to the
    eager forward + ``decode_flat`` here, with the launches the path routes.
    Then ``--format onnx`` of Darknet's card weights: ``check_model`` passes
    and the blob is the CPU export's of the same weights, byte for byte.
    Returns (the replays' launches, numbers for the line)."""
    import os

    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.export import export_program
    from yolojax_torch.kernels.ops import op_counts
    from yolojax_torch.ops.decode import decode_flat
    from yolojax_torch.tools.onnx_export import check_model, export_onnx

    DEPLOY_DIR.mkdir(parents=True, exist_ok=True)
    jobs, expect, info = {}, {}, {}
    for name, config_fn in EXPORT_PATHS.items():
        t0 = time.perf_counter()
        config = config_fn()
        _, anchors, model = build(config)
        expect[name] = launches_of(model, post=False)
        ops = {k: v for k, v in expect[name].items() if v}
        params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
        folded = model.fold(params, state)
        program = export_program(model, folded, anchors, SIZE, batch=8)
        if op_counts(program.graph) != ops:
            raise AssertionError(f"export {name}: the graph calls {op_counts(program.graph)}, "
                                 f"expected {ops}")
        path = DEPLOY_DIR / f"{name}.pt2"
        torch.export.save(program, path)
        x = seeded_images(80, 8)
        with torch.inference_mode():
            want = decode_flat(model.apply_folded(folded, x), torch.as_tensor(anchors,
                                                                              device="cuda"))
        torch.save((x, want), DEPLOY_DIR / f"{name}.io.pt")
        jobs[name] = [str(path), str(DEPLOY_DIR / f"{name}.io.pt")]
        info[name] = {"ops": ops, "export_s": time.perf_counter() - t0,
                      "mb": os.path.getsize(path) / 2**20}
        log(f"[deploy] export {name}: {type(model).__name__}, kernels {sorted(model.pallas)}, "
            f"B=8 at {SIZE}: custom-op calls {ops or 'none'}; {info[name]['mb']:.1f} MiB "
            f"saved in {info[name]['export_s']:.1f} s")
        if name == "darknet":
            folded_cpu = {k: {n: v.cpu() for n, v in lp.items()} for k, lp in folded.items()}
            blob = export_onnx(model, folded, anchors, SIZE, batch=8)
            summary = check_model(blob)
            if blob != export_onnx(model, folded_cpu, anchors, SIZE, batch=8):
                raise AssertionError("export onnx: the card's weights give another blob than "
                                     "the CPU's")
            info["onnx"] = {"bytes": len(blob), "nodes": summary["nodes"]}
            log(f"[deploy] export --format onnx of Darknet-19's card weights: check_model "
                f"passes ({summary['nodes']} nodes, {summary['initializers']} initializers), "
                f"{len(blob)} bytes, equal to the CPU export's")
        del program, model, folded, params, state

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", REPLAY, json.dumps(jobs)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600, check=False)
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"export: the replay process exited {proc.returncode}")
    replays = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = per_batch()
    for name, got in replays.items():
        if got["launches"] != expect[name] or not got["same_bits"]:
            raise AssertionError(f"export {name}: the replay launched {got['launches']} "
                                 f"(expected {expect[name]}), bit-identical "
                                 f"{got['same_bits']}, max abs err {got['max_abs_err']:.3g}")
        launches = summed(launches, got["launches"])
        info[name]["replay_launches"] = {k: v for k, v in got["launches"].items() if v}
    log(f"[deploy] a fresh process loaded the four programs (import "
        f"yolojax_torch.kernels.ops, torch.export.load) and replayed each bit-identical to "
        f"the eager forward + decode_flat, launching {launches} in all "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches, info


def prune_paths(final: str) -> tuple[dict, dict]:
    """``cli/prune.py`` at ratio 0.3 on the train phase's checkpoint, the
    model rebuilt with ``model/channels``, ``detect_fn`` on the card; then a
    seeded Darknet-s2d with γ spread over U(0, 1.5), pruned and run with and
    without ``pool reorg`` in f32 (TF32 off): the raw heads bit-identical and
    the launches the routing gives at the pruned widths.  Returns
    (launches, numbers for the line)."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.prune import main as prune_main
    from yolojax_torch.models.inference import Inference
    from yolojax_torch.tools.prune import prune, save_channels

    out = DEPLOY_DIR / "pruned"
    argv = ["-m", f"config/root={TRAIN_ROOT}", "model/name=smoke", "-f", final, "--ratio",
            str(PRUNE_RATIO), "-o", str(out)]
    if prune_main(argv) != 0:
        raise AssertionError("prune: the CLI failed")
    step = TRAIN_STEPS + TRAIN_RESUME_STEPS
    config = deploy_config(f"model/channels={out / 'channels.json'}")
    _, _, model = build(config)
    params, state, meta = load_weights_auto(config, model, str(out / f"{step}.npz"),
                                            device="cuda")
    _, _, full = build(deploy_config())
    count = lambda m: sum(d.out_ch * d.in_ch // d.groups * d.ksize ** 2 for d in m.layer_defs)
    inference = Inference(model)
    folded = inference.fold(params, state)
    run = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
    counters = zero_counters()
    outs = [run(folded, seeded_images(90 + i, 8)) for i in range(DEPLOY_BATCHES)]
    launches = read_counters(counters)
    if launches != launches_of(model, DEPLOY_BATCHES) or not all(
            bool(torch.isfinite(t).all()) for o in outs for t in (o.yx_min, o.yx_max, o.conf)):
        raise AssertionError(f"prune: the pruned model's detect launched {launches}")
    result = {"ratio": PRUNE_RATIO, "weights_before": count(full), "weights_after": count(model),
              "channels": json.loads((out / "channels.json").read_text()),
              "step": meta.get("step")}
    log(f"[deploy] cli.prune --ratio {PRUNE_RATIO} on {Path(final).name}: conv weights "
        f"{result['weights_before']} -> {result['weights_after']}; rebuilt with model/channels, "
        f"detect_fn on {DEPLOY_BATCHES} batches of 8: finite, launches {launches}")

    # a seeded Darknet-s2d with spread γ: the routed forward at the pruned widths
    config = s2d_config(dtype="float32")
    _, _, s2d = build(config)
    params, state, _ = load_weights_auto(config, s2d, rng_seed=3, device="cuda")
    gen = torch.Generator().manual_seed(4)
    for lp in params.values():
        if "gamma" in lp:
            lp["gamma"] = (torch.rand(lp["gamma"].shape, generator=gen) * 1.5).cuda()
    p2, s2, channels = prune(s2d, params, state, PRUNE_RATIO)
    save_channels(str(DEPLOY_DIR / "s2d_channels.json"), channels)
    pruned_cfg = s2d_config(dtype="float32")
    pruned_cfg.set("model", "channels", str(DEPLOY_DIR / "s2d_channels.json"))
    _, _, pruned = build(pruned_cfg)
    folded = pruned.fold(p2, s2)
    expect = launches_of(pruned, post=False)
    x = seeded_images(91, 8)
    counters = zero_counters()
    with torch.inference_mode():
        got = pruned.apply_folded(folded, x)
    s2d_launches = read_counters(counters)
    with torch.inference_mode():
        want = plain(without(pruned, {"pool", "reorg"}).apply_folded)(folded, x)
    if s2d_launches != expect:
        raise AssertionError(f"prune s2d: launched {s2d_launches}, the routing gives {expect}")
    if not torch.equal(bits(got), bits(want)):
        raise AssertionError(f"prune s2d: the routed raw head differs from the plain one "
                             f"(max abs diff {(got - want).abs().max().item():.4g})")
    result["s2d_channels"] = {k: channels[k] for k in ("c5", "c8", "c13", "c21")}
    log(f"[deploy] a pruned Darknet-s2d (γ ~ U(0, 1.5), ratio {PRUNE_RATIO}; c5, c8, c13, c21 "
        f"at {result['s2d_channels']}) with pool reorg: launches {s2d_launches} as the routing "
        f"gives (every conv → pool pair takes the kernel, at any width); f32 raw head "
        f"bit-identical to the plain forward")
    return summed(launches, s2d_launches), result


def tools_paths() -> dict:
    """receptive_field of Darknet-19 at 416 in f32 on the card against the
    CPU; plan_to_dot of the four paths; demo_graph's export dump of
    Darknet-s2d; demo_data's samples from the train cache; entry() on the
    card.  Returns numbers for the line."""
    from yolojax_torch.cli.common import build
    from yolojax_torch.cli.demo_data import samples
    from yolojax_torch.cli.demo_graph import graph_dump, plan_to_dot
    from yolojax_torch.cli.receptive_field import receptive_field
    from yolojax_torch.entry import entry

    result = {}
    config = darknet_config()
    config.set("model", "dtype", "float32")
    _, _, model = build(config)
    rf = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        params, state = model.init(torch.Generator().manual_seed(0), device)
        rf[device] = receptive_field(model, params, state, SIZE)[1:] + (time.perf_counter() - t0,)
    (support, eff, card_s), (cpu_support, cpu_eff, cpu_s) = rf["cuda"], rf["cpu"]
    if support != cpu_support or abs(eff - cpu_eff) > RF_RTOL * abs(cpu_eff):
        raise AssertionError(f"receptive_field: card {support} {eff} vs CPU {cpu_support} "
                             f"{cpu_eff}")
    result["receptive_field"] = {"support": support, "effective": eff, "cpu_effective": cpu_eff}
    log(f"[deploy] receptive_field of Darknet-19 at {SIZE} (f32): support {support}, effective "
        f"RF {eff:.4f} px on the card ({card_s:.1f} s), {cpu_eff:.4f} on the CPU ({cpu_s:.1f} "
        f"s): the same support, {abs(eff - cpu_eff) / abs(cpu_eff):.2g} apart")

    dots = {}
    for name, config_fn in EXPORT_PATHS.items():
        dot = plan_to_dot(model_of(config_fn()))
        if not (dot.startswith("digraph yolojax {") and dot.endswith("}")):
            raise AssertionError(f"plan_to_dot {name}: malformed")
        dots[name] = dot.count(" -> ")
    s2d = model_of(s2d_config())
    text, code, program = graph_dump(s2d, SIZE, "cuda")
    calls = {k: text.count(f"yolojax_torch.{k}.default(") for k in ("maxpool2x2", "reorg_s2d")}
    forward = launches_of(s2d, post=False)
    if calls != {k: forward[k] for k in calls} or "def forward" not in code:
        raise AssertionError(f"demo_graph: the Darknet-s2d dump calls {calls}")
    result["plan_edges"], result["graph_lines"] = dots, text.count("\n")
    log(f"[deploy] plan_to_dot edges {dots}; demo_graph's Darknet-s2d program: "
        f"{result['graph_lines']} lines, custom-op calls {calls}, fx code "
        f"{code.count(chr(10))} lines")

    _, train_config = train_args()
    images_by_path, _ = synth_records()
    images, boxes = samples(train_config, 8, SIZE, seed=0, device="cuda",
                            imread=images_by_path.__getitem__)
    if images.shape != (8, SIZE, SIZE, 3) or not np.isfinite(images).all() or len(boxes) != 8:
        raise AssertionError(f"demo_data: images {images.shape}, {len(boxes)} box sets")
    for ymin, ymax, cls in boxes:
        if not (len(cls) and (ymin >= 0).all() and (ymax <= 1).all() and (ymin <= ymax).all()):
            raise AssertionError("demo_data: a sample's boxes leave the image")
    result["demo_data_boxes"] = [len(b[2]) for b in boxes]
    log(f"[deploy] demo_data samples from the train cache: 8 images {images.shape[1:]}, boxes "
        f"per image {result['demo_data_boxes']}, all inside the image")

    fn, (folded, images) = entry()
    out = fn(folded, images)
    if not all(t.is_cuda for t in out) or not all(bool(torch.isfinite(t).all())
                                                   for t in out[:3]):
        raise AssertionError("entry(): outputs not finite or not on cuda")
    result["entry_picks"] = int(out.keep.sum())
    log(f"[deploy] entry(): Darknet-19 at 416, bf16, batch {images.shape[0]} on "
        f"{images.device}: outputs finite, {result['entry_picks']} picks")
    return result


def deploy_phase(card: str, final: str) -> tuple[dict, dict]:
    """Phase 12: host detect and BASELINE config 1, export and replay, prune,
    the tools.  Returns (launches, the deploy line)."""
    t0 = time.perf_counter()
    host_launches, host = host_detect(final)
    export_launches, exported = export_paths()
    prune_launches, pruned = prune_paths(final)
    tools = tools_paths()
    result = {"card": card, **host, "export": exported, "prune": pruned, **tools,
              "seconds": time.perf_counter() - t0}
    log(f"[deploy] the deploy phase took {result['seconds']:.1f} s")
    return summed(host_launches, export_launches, prune_launches), result


# -- the data-parallel phase -----------------------------------------------------

DIST_RANKS = 2              # processes in one gloo group on cuda:0 (NCCL refuses two on one card)
DIST_SIZE, DIST_BATCH, DIST_STEPS = 160, 2, 3       # (a) f32 parity, B a rank; (c) batches
DIST_FULL_BATCH, DIST_FULL_STEPS = 8, 4             # (b) full width, bf16 at 416, B a rank
# the train CLI's --batch is the node's (the ranks of one machine): B a rank x DIST_RANKS
# (a) ranks against one process at the global batch: components and grad_norm rtol at the
# first step and after; the params' change, the momentum trace and the BN state as
# ‖ranks − one‖ / ‖one‖ over the model.  The two sum the BN statistics and the gradients
# in other orders, and cuDNN's f32 convolutions differ with the batch (B=2 a rank, 4 in
# one process); at 160², B=2 a rank, BN amplifies that rounding: one step's params'
# change moves by 1e-3 to 1e-2 between card and CPU (the train phase's TRAIN_PARITY), and
# over three steps the components by up to 3e-3 (seen on the H100).  So the first step is
# held at 1e-4, the later ones at 1e-2, the change at the train phase's 2e-2, the trace,
# which the later steps' gradients dominate, at 3x it (test_torch_train_step.py's ratio),
# and the BN state at 1e-5; tests/test_torch_dist_train.py holds the same sync in f64 to
# 1e-9, and a rank's BN state without the sync lies 2e-3 away.  Under deterministic cuDNN
# the one-process run repeats itself exactly (0 on all five, seen on the H100), and the
# ranks' gap stays (4.7e-3 after step 1, 5.0e-2 on the momentum): it is the arithmetic of
# B=2 a rank against B=4, not the card's noise, so the bounds stay where they are
DIST_PARITY = {"first": 1e-4, "later": 1e-2, "change": 2e-2, "trace": 6e-2, "state": 1e-5}
DIST_EVAL_PARITY = {"map": 1e-4, "ap": 1e-3}        # (d) against phase 11's f32 card eval
COMPONENTS = ("coord", "object", "noobject", "cls", "prior", "total", "grad_norm")


def dist_args(name: str, *argv):
    """``train_args`` for a run of the data-parallel phase: model ``name``
    under TRAIN_ROOT (the train phase's cache), no prewarm."""
    return train_args("-m", f"model/name={name}", "train/prewarm=0", *argv)


def parity_args(name: str, batch: int):
    """(a): f32 model and pixels at DIST_SIZE², the device-resident dataset
    (the same global batches in one process and on the ranks), DIST_STEPS of
    ``tests/test_torch_train_step.py``'s sgd, whose bounds DIST_PARITY are
    (clip 5, BN-γ sparsity 0.01, a milestone at step 2)."""
    return dist_args(name, "-m", "model/dtype=float32", "transform/dtype=float32",
                     f"train/multi_scale_min={DIST_SIZE}", f"train/multi_scale_max={DIST_SIZE}",
                     "train/milestones=2", "train/gamma=0.1", "train/sparsity=0.01",
                     "data/device_dataset=1", "--batch", str(batch), "--steps", str(DIST_STEPS))


def full_args():
    """(b): config.ini's Darknet-19 in bf16 at SIZE through the loader."""
    return dist_args("dist-full", "-m", f"train/multi_scale_min={SIZE}",
                     f"train/multi_scale_max={SIZE}", "--batch", str(DIST_FULL_BATCH * DIST_RANKS),
                     "--steps", str(DIST_FULL_STEPS))


def batches_args(batch: int):
    """(c): the device-resident dataset's batches of ``batch`` a rank."""
    return dist_args("dist-batches", "-m", "data/device_dataset=1", "--batch", str(batch))


def tree_digest(*trees) -> str:
    """A hash of every leaf's bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for tree in trees:
        for k in sorted(tree):
            for n in sorted(tree[k]):
                h.update(tree[k][n].detach().contiguous().reshape(-1).view(torch.uint8)
                         .cpu().numpy().tobytes())
    return h.hexdigest()


def eval_imread():
    """The eval phase's cv2 stand-in's imread, in RGB (a fresh rank has no
    module of its own)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke_cv2_stub",
                                                  EVAL_DIR / "stub" / "cv2.py")
    cv2_stub = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cv2_stub)
    return lambda path: cv2_stub.imread(path)[:, :, ::-1]


def dist_rank(group, final: str) -> dict:
    """One rank of the data-parallel phase, on cuda:0: (a) the f32 parity
    run, (b) the full-width run, (c) the device-resident batches, (d) eval
    across the ranks, each through the entry points a user calls.  Returns
    what the parent checks."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.eval import run_eval
    from yolojax_torch.cli.train import Train
    from yolojax_torch.data.cache import load_cache

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, _ = synth_records()
    out = {}

    torch.backends.cudnn.deterministic = True       # (a) holds the ranks to DIST_PARITY
    args, config = parity_args("dist-ranks", DIST_BATCH * DIST_RANKS)
    train = Train(args, config, imread=images.__getitem__)
    if train.group is None or train.world != DIST_RANKS or train.batch_size != DIST_BATCH:
        raise AssertionError(f"dist: Train found no group of {DIST_RANKS} ranks, or took "
                             f"{train.batch_size} images a rank, not {DIST_BATCH}")
    train(max_steps=args.steps)
    out["parity"] = {"seen": train.seen, "digest": tree_digest(
        train.params, train.state, train.opt_state["trace"])}
    del train
    torch.backends.cudnn.deterministic = False

    args, config = full_args()
    train = Train(args, config, imread=images.__getitem__)
    if train.batch_size != DIST_FULL_BATCH:
        raise AssertionError(f"dist (b): {train.batch_size} images a rank, not {DIST_FULL_BATCH}")
    start = {k: {n: v.clone() for n, v in lp.items()} for k, lp in train.params.items()}
    step, step_ms = train.train_step, []

    def timed(*a):
        t0 = time.perf_counter()
        res = step(*a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    train.train_step = timed
    train(max_steps=args.steps)
    out["full"] = {"step_ms": step_ms, "seen": train.seen,
                   "unchanged": [f"{k}.{n}" for k, lp in start.items() for n, v in lp.items()
                                 if torch.equal(v, train.params[k][n])],
                   "digest": tree_digest(train.params, train.state)}
    del train, start

    args, config = batches_args(DIST_BATCH * DIST_RANKS)
    source = Train(args, config, imread=images.__getitem__).device_batches()
    out["batches"] = [{k: v.cpu() for k, v in next(source).items()} for _ in range(DIST_STEPS)]
    del source

    imread, out["eval"] = eval_imread(), {}
    counters = launch_counters()
    for dtype in ("float32", "bfloat16"):
        cfg = eval_config(f"model/dtype={dtype}")
        category, _, model = build(cfg)
        params, state, _ = load_weights_auto(cfg, model, final, device=TRAIN_DEVICE)
        records = load_cache(cfg, "test")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        result = run_eval(cfg, model, params, state, records, SIZE, EVAL_BATCH, category,
                          imread=imread, group=group)
        torch.cuda.synchronize()
        out["eval"][dtype] = {"launches": {name: fn.launches for name, fn in counters.items()},
                              "seconds": time.perf_counter() - t0, "map": result["map"],
                              "ap": {category[c]: v for c, v in result["ap"].items()},
                              "detections": sum(len(d) for d in result["recorder"].dets.values())}
    return out


def scalar_rows(config) -> list[dict]:
    from yolojax_torch.config import get_model_dir

    path = Path(get_model_dir(config)) / "scalars.jsonl"
    return [json.loads(line) for line in path.read_text().splitlines()]


def parity_errs(got: dict, want: dict, start: dict) -> dict:
    """Two parity runs ({rows, params, state, trace}) apart: the components'
    and grad_norm's largest relative gap at the first step and after, and
    ‖got − want‖ / ‖want‖ of the params' change from ``start``, the momentum
    trace and the BN state."""
    worst = [0.0, 0.0]
    for i, (g, w) in enumerate(zip(got["rows"], want["rows"])):
        for k in COMPONENTS:
            worst[i > 0] = max(worst[i > 0], abs(g[k] - w[k]) / abs(w[k]))
    change = lambda tree: {k: {n: v - start[k][n] for n, v in lp.items()}
                           for k, lp in tree.items()}
    return {"first": worst[0], "later": worst[1],
            "change": tree_rel(change(got["params"]), change(want["params"])),
            "trace": tree_rel(got["trace"], want["trace"]),
            "state": tree_rel(got["state"], want["state"])}


def dist_parity(ranks) -> dict:
    """(a): the ranks' run against ``Train`` in this process at the global
    batch, from the same seed on the same device batches; and, for scale,
    that one-process run against itself run again."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.train import Train
    from yolojax_torch.config import get_model_dir
    from yolojax_torch.utils import checkpoint as ckpt

    images, _ = synth_records()
    cpu = lambda tree: {k: {n: v.cpu() for n, v in lp.items()} for k, lp in tree.items()}
    runs = {}
    torch.backends.cudnn.deterministic = True
    for name in ("dist-one", "dist-one-again"):
        args, config = parity_args(name, DIST_BATCH * DIST_RANKS)
        one = Train(args, config, imread=images.__getitem__)
        start = {k: {n: v.cpu().clone() for n, v in lp.items()} for k, lp in one.params.items()}
        one(max_steps=args.steps)
        runs[name] = {"rows": scalar_rows(config), "params": cpu(one.params),
                      "state": cpu(one.state), "trace": cpu(one.opt_state["trace"]),
                      "seen": one.seen}
        del one
    torch.backends.cudnn.deterministic = False
    want = runs["dist-one"]
    _, ranks_config = parity_args("dist-ranks", DIST_BATCH * DIST_RANKS)
    path = Path(get_model_dir(ranks_config)) / f"{DIST_STEPS}.npz"
    params, state, meta = load_weights_auto(ranks_config, build(ranks_config)[2], str(path))
    trace = {k: {n: torch.from_numpy(v) for n, v in lp.items()}
             for k, lp in ckpt.load(str(path), ("opt",))[0]["opt"]["trace"].items()}
    got = {"rows": scalar_rows(ranks_config), "params": params, "state": state, "trace": trace}
    errs = parity_errs(got, want, start)
    again = parity_errs(runs["dist-one-again"], want, start)
    same = ranks[0]["parity"]["digest"] == ranks[1]["parity"]["digest"]
    seen = [r["parity"]["seen"] for r in ranks]
    fmt = lambda e: (f"components and grad_norm max rel diff {e['first']:.3g} at step 1, "
                     f"{e['later']:.3g} after; params' change {e['change']:.3g}, momentum "
                     f"{e['trace']:.3g}, BN state {e['state']:.3g}")
    log(f"[dist] (a) Train on {DIST_RANKS} ranks, B={DIST_BATCH} each, against one process at "
        f"B={DIST_BATCH * DIST_RANKS} (f32, {DIST_SIZE}², TF32 off, deterministic cuDNN, the "
        f"device-resident "
        f"dataset, {DIST_STEPS} steps): {fmt(errs)} (bounds {DIST_PARITY}); the ranks' params, "
        f"state and momentum {'bit-identical' if same else 'DIFFER'}; seen {seen}")
    log(f"[dist] (a) for scale, the one-process run against itself run again: {fmt(again)}")
    if ({len(got["rows"]), len(want["rows"])} != {DIST_STEPS} or not same
            or meta.get("seen") != want["seen"] or seen != [want["seen"]] * DIST_RANKS
            or any(errs[k] > DIST_PARITY[k] for k in errs)):
        raise AssertionError(f"dist (a): {len(got['rows'])} / {len(want['rows'])} scalar rows, "
                             f"ranks identical {same}, seen {seen} / {meta.get('seen')} / "
                             f"{want['seen']}, {errs}")
    return {**errs, "one_process_again": again}


def dist_full(ranks) -> tuple[dict, dict]:
    """(b): the full-width run's losses and parameters, and its rank-0
    checkpoint through load_weights_auto → fold → detect_fn (the fused
    launches counted).  Returns (launches, numbers)."""
    from yolojax_torch.config import get_model_dir

    _, config = full_args()
    rows = scalar_rows(config)
    bad = [(r["step"], k) for r in rows for k in COMPONENTS if not np.isfinite(r[k])]
    unchanged = [r["full"]["unchanged"] for r in ranks]
    same = ranks[0]["full"]["digest"] == ranks[1]["full"]["digest"]
    if len(rows) != DIST_FULL_STEPS or bad or any(unchanged) or not same:
        raise AssertionError(f"dist (b): {len(rows)} scalar rows, non-finite {bad}, unchanged "
                             f"{unchanged}, ranks identical {same}")
    ms = [float(np.median(r["full"]["step_ms"][1:])) for r in ranks]
    log(f"[dist] (b) Darknet-19 (config.ini, bf16, {SIZE}) on {DIST_RANKS} ranks sharing one "
        f"card, B={DIST_FULL_BATCH} each, {DIST_FULL_STEPS} steps through the loader's shards: "
        f"every loss finite (total {rows[0]['total']:.4g} → {rows[-1]['total']:.4g}), every "
        f"parameter changed, the ranks bit-identical; step ms per rank (median after the "
        f"first, information only: two processes share one card) {[f'{m:.1f}' for m in ms]}")
    final = str(Path(get_model_dir(config)) / f"{DIST_FULL_STEPS}.npz")
    launches = trained_detect({"config": config, "final": final, "steps": DIST_FULL_STEPS})
    return launches, {"first_total": rows[0]["total"], "last_total": rows[-1]["total"],
                      "step_ms": ms}


def dist_batches(ranks) -> int:
    """(c): the ranks' device batches, concatenated, against one process's
    device batches and its loader's at the global batch, bit for bit."""
    from yolojax_torch.cli.train import Train
    from yolojax_torch.data.device_cache import KEYS

    images, _ = synth_records()
    args, config = batches_args(DIST_BATCH * DIST_RANKS)
    one = Train(args, config, imread=images.__getitem__)
    source, loader = one.device_batches(), one.loader.epoch()
    for i in range(DIST_STEPS):
        want, host = next(source), next(loader)
        for k in KEYS:
            got = torch.cat([r["batches"][i][k] for r in ranks])
            if not (torch.equal(got, want[k].cpu())
                    and torch.equal(got, torch.from_numpy(host[k]))):
                raise AssertionError(f"dist (c): step {i}, {k}: the ranks' batches differ")
    log(f"[dist] (c) [data] device_dataset = 1: the {DIST_RANKS} ranks' batches of {DIST_BATCH}, "
        f"concatenated, equal one process's device batches and its loader's of "
        f"{DIST_BATCH * DIST_RANKS}, bit for bit, for {DIST_STEPS} steps")
    return DIST_STEPS


def dist_eval(ranks, eval_result: dict) -> tuple[dict, dict]:
    """(d): eval across the ranks against phase 11's one-process f32 card
    eval; every rank's launches.  Returns (launches, numbers)."""
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    want = launches_of(model_of(darknet_config()), batches)
    launches = per_batch()
    for r in ranks:
        for dtype, got in r["eval"].items():
            if got["launches"] != want:
                raise AssertionError(f"dist (d): a rank's {dtype} eval launched "
                                     f"{got['launches']}, expected {want}")
            launches = summed(launches, got["launches"])
    f32 = ranks[0]["eval"]["float32"]
    gap = {"map": abs(f32["map"] - eval_result["f32_card_map"]),
           "ap": max(abs(f32["ap"][k] - v) for k, v in eval_result["f32_card_ap"].items())}
    same = all(r["eval"][d][k] == ranks[0]["eval"][d][k] for r in ranks for d in r["eval"]
               for k in ("map", "ap", "detections"))
    bf16 = ranks[0]["eval"]["bfloat16"]
    log(f"[dist] (d) run_eval on {DIST_RANKS} ranks, {EVAL_BATCH // DIST_RANKS} images a rank "
        f"of each batch of {EVAL_BATCH}: f32 mAP {f32['map']:.6f} against one process's "
        f"{eval_result['f32_card_map']:.6f} (gap {gap['map']:.3g}, largest class AP gap "
        f"{gap['ap']:.3g}, bounds {DIST_EVAL_PARITY}), {f32['detections']} detections; bf16 "
        f"mAP {bf16['map']:.6f} (one process: {eval_result['map']:.6f}); each rank launched "
        f"{want} per eval; every rank returned rank 0's mAP: {same}")
    if (f32["ap"].keys() != eval_result["f32_card_ap"].keys() or not same
            or any(gap[k] > DIST_EVAL_PARITY[k] for k in gap)):
        raise AssertionError(f"dist (d): the eval across ranks differs: {gap}, same {same}")
    return launches, {"f32_map": f32["map"], "f32_gap": gap, "bf16_map": bf16["map"],
                      "seconds": {d: r["seconds"] for d, r in ranks[0]["eval"].items()}}


def dist_dryrun() -> str:
    """(e): ``entry.dryrun_multichip(2, device="cuda", backend="gloo")``."""
    import io

    from yolojax_torch.entry import dryrun_multichip

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        dryrun_multichip(DIST_RANKS, device="cuda", backend="gloo")
    line = printed.getvalue().strip()
    if not (line.startswith(f"dryrun_multichip({DIST_RANKS}): backbone Darknet total loss")
            and line.endswith("OK")):
        raise AssertionError(f"dist (e): dryrun_multichip printed {line!r}")
    log(f"[dist] (e) {line}")
    return line


def dist_phase(card: str, final: str, eval_result: dict) -> tuple[dict, dict]:
    """Phase 13: training and eval across two ranks on the card.  Returns
    (launches of (b) and (d), the dist line)."""
    from yolojax_torch.parallel.collectives import run_ranks

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    ranks = run_ranks(dist_rank, DIST_RANKS, final)
    ranks_s = time.perf_counter() - t0
    parity = dist_parity(ranks)
    full_launches, full = dist_full(ranks)
    dist_batches(ranks)
    eval_launches, evaluated = dist_eval(ranks, eval_result)
    dryrun = dist_dryrun()
    result = {"card": card, "ranks": DIST_RANKS, "backend": "gloo", "parity": parity,
              "full": full, "eval": evaluated, "dryrun": dryrun, "ranks_seconds": ranks_s,
              "seconds": time.perf_counter() - t0}
    log(f"[dist] the data-parallel phase took {result['seconds']:.1f} s ({ranks_s:.1f} s of it "
        "the two ranks)")
    return {k: full_launches[k] + eval_launches[k] for k in KERNELS}, result


GATE_DIR = ROOT / "build" / "chip_smoke_gate"   # git-ignored: the short gate, the overfit
GATE_IMAGES, GATE_STEPS = 100, 300  # the gate's chain at full width, cut in data and steps
# tests/test_convergence.py trains 600 steps.  On the card at 600 steps (B=2, six values of
# [train] seed, chip_smoke.py --calibrate) mAP@0.3 missed 1.0 for one seed under cuDNN's
# default algorithms (0.5) and for another under its deterministic ones (0.636); at 1200
# steps under the default ones all six read 1.0.  So the check trains 1200 steps with the
# algorithms the train CLI uses
OVERFIT_STEPS, OVERFIT_SIZE = 1200, 64
# tests/test_convergence.py's learning check: Tiny on 6 images of one 32² square each
OVERFIT_INI = """[config]
root = {root}/artifacts
[cache]
datasets = yolojax.data.voc
category = {root}/category2
voc_roots = {root}/VOC2007
[model]
name = overfit
dnn = yolojax.models.darknet.Tiny
anchors = {root}/anchors.tsv
dtype = float32
[data]
batch_size = 2
max_boxes = 5
canvas = 160
sizes = 64,64
workers = 2
[train]
learning_rate = 3e-3
clip = 5.0
multi_scale_min = 64
multi_scale_max = 64
multi_scale_interval = 2
prewarm = 0
warmup_seen = 0
seed = 0
[transform]
train =
dtype = float32
[eval]
threshold = 0.05
iou = 0.3
topk = 10
batch_size = 2
[summary]
scalar = 200
histogram = 0
image = 0
[save]
interval = 1e9
keep = 3
"""


def gate_chain(card: str) -> tuple[dict, dict]:
    """The gate's chain through ``tools/synth_gate`` at full width (Darknet-19,
    VOC, multi-scale 320–608, bf16), cut to GATE_IMAGES images and GATE_STEPS
    steps, with every launch counter set to 0 just before and read just
    after: every stage exits 0 (the tool's exit code is 0 or 1, a pass or a
    fail; 2 would be a kernel eval that disagrees), 8 finite mAPs, the COCO
    block, the criteria of ``criteria_for("darknet")``, one fused launch per
    eval batch of the grid and one nms_select launch per batch of the
    ``pallas = nms`` eval.  ``pass`` is printed, not required: 300 steps do
    not train a detector.  Returns (launches, numbers)."""
    import math
    import shutil

    from yolojax_torch.tools import synth_gate as gate

    shutil.rmtree(GATE_DIR, ignore_errors=True)
    out = GATE_DIR / "gate.json"
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rc = gate.main(["--root", str(GATE_DIR / "ws"), "--model", "darknet", "--images",
                    str(GATE_IMAGES), "--steps", str(GATE_STEPS), "--out", str(out)])
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    art = json.loads(out.read_text())
    test_images = min(max(100, GATE_IMAGES // 6), GATE_IMAGES // 2)   # generate_voc's split
    batches = math.ceil(test_images / 20)
    # the grid's evals on config.ini's route, then the kernel eval's at 416
    model = model_of(darknet_config())
    tokens = frozenset(gate.KERNEL_EVALS["darknet"][0].split())
    want = summed(*(launches_of(model, batches, size) for _ in gate.MODES for size in gate.SIZES),
                  launches_of(dataclasses.replace(model, pallas=tokens), batches))
    maps = art["map"]
    if (rc not in (0, 1) or len(maps) != 8
            or not all(np.isfinite(v) and 0 <= v <= 1 for v in maps.values())
            or set(art["coco_ap_416_stretch"]) != {"ap", "ap50", "ap75"}
            or art["criteria"] != gate.criteria_for("darknet") or launches != want
            or art["train"]["step"] != GATE_STEPS):
        raise AssertionError(f"gate: exit {rc}, grid {maps}, coco {art['coco_ap_416_stretch']}, "
                             f"launches {launches} (expected {want}), step "
                             f"{art['train']['step']}")
    log(f"[gate] {card} | python -m yolojax_torch.tools.synth_gate --model darknet --images "
        f"{GATE_IMAGES} --steps {GATE_STEPS} (Darknet-19, VOC, multi-scale 320-608, bf16, "
        f"{art['dataset']['codec']}): every stage exited 0 in {seconds:.1f} s (train "
        f"{art['train']['wall_s']} s with cache and k-means); grid {maps}; COCO AP "
        f"{art['coco_ap_416_stretch']}; pass {art['pass']} (printed, not required: "
        f"{GATE_STEPS} steps train no detector); launches {launches}, one fused launch per "
        f"eval batch ({batches} a grid cell); pallas = nms eval "
        f"{art['kernel_evals']['stretch_416']}")
    return launches, {"seconds": seconds, "map": maps, "coco": art["coco_ap_416_stretch"],
                      "pass": art["pass"], "train_wall_s": art["train"]["wall_s"],
                      "kernel_evals": art["kernel_evals"]}


def overfit_workspace(root: Path) -> list:
    """tests/test_cli_end_to_end.py's workspace: 6 images of 96x128 with one
    32² square of one of two classes, as binary PPM (read without cv2)."""
    voc = root / "VOC2007"
    for sub in ("ImageSets/Main", "Annotations", "JPEGImages"):
        (voc / sub).mkdir(parents=True)
    rng = np.random.default_rng(3)
    ids = []
    for i in range(6):
        h, w, cls = 96, 128, i % 2
        img = np.full((h, w, 3), 40, np.uint8)
        y0, x0 = int(rng.integers(8, h - 40)), int(rng.integers(8, w - 40))
        img[y0:y0 + 32, x0:x0 + 32] = (255, 64, 64) if cls == 0 else (64, 255, 64)
        ids.append(f"{i:06d}")
        (voc / "JPEGImages" / f"{ids[-1]}.jpg").write_bytes(
            f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
        (voc / "Annotations" / f"{ids[-1]}.xml").write_text(
            f"<annotation><size><width>{w}</width><height>{h}</height></size><object><name>"
            f"{('square', 'blob')[cls]}</name><difficult>0</difficult><bndbox><xmin>{x0 + 1}"
            f"</xmin><ymin>{y0 + 1}</ymin><xmax>{x0 + 32}</xmax><ymax>{y0 + 32}</ymax>"
            "</bndbox></object></annotation>")
    for phase in ("trainval", "val", "test"):
        (voc / "ImageSets" / "Main" / f"{phase}.txt").write_text(
            "\n".join(ids if phase == "trainval" else ids[:4]))
    (root / "category2").write_text("square\nblob")
    (root / "anchors.tsv").write_text("1.0\t1.0\n2.5\t2.5\n")
    (root / "overfit.ini").write_text(OVERFIT_INI.format(root=root))
    return ["-c", str(ROOT / "config.ini"), str(root / "overfit.ini")]


def overfit_run(device: str = "cuda", steps: int = OVERFIT_STEPS, seed: int = 0,
                deterministic: bool = False) -> dict:
    """tests/test_convergence.py on ``device``: Tiny trained on the 6-image
    workspace for ``steps`` steps at 64² (no augmentation, lr 3e-3, f32,
    ``[train] seed``) through the cache and train CLIs' code, under cuDNN's
    deterministic algorithms or the train CLI's default ones; returns
    {"map", "ap", "step", "train_s"}: mAP@0.3 (threshold 0.05) at 64."""
    import shutil

    from yolojax_torch.cli import make_parser, setup
    from yolojax_torch.cli.cache import main as cache_main
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.eval import run_eval
    from yolojax_torch.cli.train import main as train_main
    from yolojax_torch.data.cache import load_cache

    root = GATE_DIR / "overfit"
    shutil.rmtree(root, ignore_errors=True)
    cfg = overfit_workspace(root) + ["-m", f"train/seed={seed}"]
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = deterministic
    try:
        if cache_main(cfg) != 0 or train_main(cfg + ["--steps", str(steps),
                                                     "--device", device]) != 0:
            raise AssertionError("overfit: the cache or train step failed")
    finally:
        torch.backends.cudnn.deterministic = False
    train_s = time.perf_counter() - t0
    config = setup(make_parser("overfit eval").parse_args(cfg))
    category, _, model = build(config)
    params, state, meta = load_weights_auto(config, model, None, resume=True, device=device)
    result = run_eval(config, model, params, state, load_cache(config, "test"), OVERFIT_SIZE,
                      config.getint("eval", "batch_size"), category)
    return {"map": result["map"], "ap": result["ap"], "step": meta.get("step"),
            "train_s": train_s}


def overfit_check(card: str, device: str = "cuda") -> dict:
    """:func:`overfit_run` under the train CLI's algorithms for OVERFIT_STEPS
    steps: mAP@0.3 must be 1.0 (to 1e-9)."""
    run = overfit_run(device)
    log(f"[gate] {card} | overfit (tests/test_convergence.py): Tiny, 6 images, "
        f"{OVERFIT_SIZE}², {run['step']} steps in {run['train_s']:.1f} s: mAP@0.3 "
        f"{run['map']:.6f} (required 1.0), per class {run['ap']}")
    # 1.0 up to the float rounding of the AP's 11-point sum (1.0000000000000002 on the CPU)
    if run["step"] != OVERFIT_STEPS or abs(run["map"] - 1.0) > 1e-9:
        raise AssertionError(f"overfit: mAP@0.3 {run['map']} after {run['step']} steps")
    return {"map": run["map"], "train_s": run["train_s"]}


def gate_phase(card: str) -> tuple[dict, dict]:
    """Phase 14: the gate's chain at full width, short, and the overfit
    learning check.  Returns (launches of the chain, the gate line)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    launches, chain = gate_chain(card)
    overfit = overfit_check(card)
    result = {"card": card, "chain": chain, "overfit": overfit,
              "seconds": time.perf_counter() - t0}
    log(f"[gate] phase 14 took {result['seconds']:.1f} s")
    return launches, result


# -- the prune gate -----------------------------------------------------------------

# the prune gate's chain at full width, cut in data and steps: the source's, the finetune's
PRUNE_IMAGES, PRUNE_STEPS, PRUNE_FINETUNE_STEPS = 100, 200, 100
PRUNE_EVALS = ("dense", "pruned", "finetuned")


def pruned_picks(root: Path, art: dict, card: str) -> float:
    """The pruned checkpoint's raw head on the first EVAL_BATCH eval images,
    as its eval computes it, through the fused kernel against its plain
    version at eval's point (topk 300), in f32 and bf16; returns the largest
    abs difference."""
    from yolojax_torch import cli
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.data.cache import load_cache
    from yolojax_torch.data.dataset import _imread_rgb
    from yolojax_torch.tools import prune_gate

    channels = root / "pruned" / "channels.json"
    config = cli.setup(cli.make_parser("prune picks").parse_args(
        ["-c", str(ROOT / "config.ini"), str(root / "gate.ini"),
         *prune_gate.pins(art["sparsity"]), "-m", f"model/channels={channels}"]))
    config.set("transform", "resize", "yolojax.data.transform.stretch")
    _, _, model = build(config)
    ckpt = root / "pruned" / f"{art['source']['step']}.npz"
    params, state, _ = load_weights_auto(config, model, str(ckpt), device="cuda")
    raw, anchors = trained_heads(config, params, state, load_cache(config, "test"), _imread_rgb)
    return max(fused_case(raw.to(dtype), anchors, model.num_classes,
                          f"{tuple(raw.shape)} pruned {str(dtype)[6:]} topk {EVAL_TOPK} ({card})",
                          EVAL_TOPK)
               for dtype in (torch.float32, torch.bfloat16))


def prune_phase(card: str) -> tuple[dict, dict]:
    """Phase 15: ``python -m yolojax_torch.tools.prune_gate``'s ``main`` in this
    process at full width (Darknet-19, VOC, bf16, ``--fresh``), cut to
    PRUNE_IMAGES images, PRUNE_STEPS source steps and PRUNE_FINETUNE_STEPS
    finetune steps, with every launch counter set to 0 just before and read
    just after: every stage exits 0 (exit code 0 or 1, a pass or a fail),
    ``channels_kept`` below the dense model's count over the same layers,
    the finetune at its last step, one fused launch per eval batch on the
    dense, pruned and finetuned evals and nothing else.  Then the pruned
    checkpoint's head through the fused kernel against its plain version.
    ``pass`` is printed, not required.  Returns (launches, the phase's line)."""
    import math
    import shutil

    from yolojax_torch import cli
    from yolojax_torch.cli.common import build
    from yolojax_torch.tools import prune_gate, synth_gate

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    root = GATE_DIR / "prune"
    shutil.rmtree(root, ignore_errors=True)
    out = GATE_DIR / "prune.json"
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    rc = prune_gate.main(["--fresh", "--root", str(root), "--images", str(PRUNE_IMAGES),
                          "--steps", str(PRUNE_STEPS), "--finetune-steps",
                          str(PRUNE_FINETUNE_STEPS), "--out", str(out)])
    chain_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    art = json.loads(out.read_text())

    channels = json.loads((root / "pruned" / "channels.json").read_text())
    _, _, dense_model = build(cli.setup(cli.make_parser("dense").parse_args(
        ["-c", str(ROOT / "config.ini"), str(root / "gate.ini")])))
    dense = sum(d.out_ch for d in dense_model.layer_defs if d.name in channels)
    test_images = min(max(100, PRUNE_IMAGES // 6), PRUNE_IMAGES // 2)   # generate_voc's split
    batches = math.ceil(test_images / 20)
    per_eval = launches_of(dense_model, batches)
    want = scaled(per_eval, len(PRUNE_EVALS))
    # the gate's own counts leave out the kernels it counts no launches of
    counted = {k: v for k, v in per_eval.items() if v and k in synth_gate.launches()}
    maps = {k: art[f"map_{k}_416"] for k in PRUNE_EVALS}
    if (rc not in (0, 1) or launches != want
            or art["eval_launches"] != dict.fromkeys(PRUNE_EVALS, counted)
            or not art["channels_kept"] < dense or art["source"]["step"] != PRUNE_STEPS
            or not all(np.isfinite(v) and 0 <= v <= 1 for v in maps.values())):
        raise AssertionError(f"prune gate: exit {rc}, launches {launches} (expected {want}), "
                             f"per eval {art['eval_launches']}, channels kept "
                             f"{art['channels_kept']} of {dense}, source step "
                             f"{art['source']['step']}, mAP {maps}")
    err = pruned_picks(root, art, card)
    result = {"card": card, "map": maps, "channels_kept": art["channels_kept"],
              "channels_dense": dense, "pass": art["pass"], "eval_launches": art["eval_launches"],
              "stage_seconds": art["stage_seconds"], "fused_vs_plain_err": err,
              "chain_seconds": chain_s, "seconds": time.perf_counter() - t0}
    log(f"[prune] {card} | python -m yolojax_torch.tools.prune_gate --fresh --images "
        f"{PRUNE_IMAGES} --steps {PRUNE_STEPS} --finetune-steps {PRUNE_FINETUNE_STEPS} "
        f"(Darknet-19, VOC, 416, bf16): every stage exited 0 in {chain_s:.1f} s; "
        f"channels kept {art['channels_kept']} of {dense}; mAP@0.5 {maps}; pass {art['pass']} "
        f"(printed, not required: {PRUNE_STEPS} steps train no detector); launches {launches}: "
        f"one fused launch per eval batch, {batches} an eval ({art['eval_launches']}); "
        f"stages {art['stage_seconds']}; the pruned head's picks match the plain version")
    log(f"[prune] phase 15 took {result['seconds']:.1f} s")
    return launches, result


# -- the bench -----------------------------------------------------------------------

BENCH_DIR = ROOT / "build" / "chip_smoke_bench"   # git-ignored: the sustained record
BENCH_ITERS = 5             # timed calls (steps, batches) a run; warm ones come on top
BENCH_WARM_CALLS = 2        # detect calls before an infer or latency run's timed ones
SUSTAINED_SECONDS = 10
BENCH_DW = "nms,fusedpost,dwconv,dwsep"
BENCH_FRESH_LATENCY = 3     # latency runs, each in a process of its own
# (label, environment): each run is ``python -m yolojax_torch.tools.bench``'s
# ``main`` under that environment
BENCH_RUNS = [
    ("infer darknet 416", {}),
    ("infer darknet 320", {"BENCH_SIZE": "320"}),
    ("infer darknet 608", {"BENCH_SIZE": "608"}),
    ("infer tiny 416", {"BENCH_MODEL": "tiny"}),
    ("infer mobilenet 416", {"BENCH_MODEL": "mobilenet"}),
    ("infer darknet 416 nms", {"BENCH_PALLAS": "nms"}),
    ("infer mobilenet 416 " + BENCH_DW, {"BENCH_MODEL": "mobilenet", "BENCH_PALLAS": BENCH_DW}),
    ("latency darknet 416", {"BENCH_MODE": "latency"}),
    ("train darknet 416 B=16", {"BENCH_MODE": "train", "BENCH_BATCH": "16"}),
    ("e2e darknet 416 B=16", {"BENCH_MODE": "e2e", "BENCH_BATCH": "16"}),
    ("e2e devdata darknet 416 B=16", {"BENCH_MODE": "e2e", "BENCH_BATCH": "16",
                                      "BENCH_E2E_DEVDATA": "1"}),
    ("pipeline 416 B=128", {"BENCH_MODE": "pipeline"}),
]
BENCH_ENV = ("BENCH_BATCH", "BENCH_ITERS", "BENCH_MODE", "BENCH_MODEL", "BENCH_SIZE",
             "BENCH_PALLAS", "BENCH_SATURATED", "BENCH_E2E_DEVDATA", "BENCH_E2E_DECOMP")


def bench_metric(env: dict) -> str:
    """The metric name ``bench.py`` prints under ``env``."""
    mode, model = env.get("BENCH_MODE", "infer"), env.get("BENCH_MODEL", "darknet")
    tag = "" if model == "darknet" else f"_{model}"
    size = env.get("BENCH_SIZE", "416")
    if mode == "latency":
        return f"yolov2{tag}_{size}_detect_latency_ms"
    if mode == "e2e" and env.get("BENCH_E2E_DEVDATA") == "1":
        mode = "e2e_devdata"
    return f"yolov2{tag}_{size}_{mode}_images_per_sec_per_chip"


def bench_launches(env: dict, calls: int) -> dict:
    """The launches of ``calls`` detect calls of ``tools/bench.py``'s model
    under ``env``: ``flagship(backbone=BENCH_MODEL)`` with the BENCH_PALLAS
    tokens at BENCH_SIZE."""
    from yolojax_torch.entry import flagship

    model = flagship(backbone=env.get("BENCH_MODEL", "darknet"))
    tokens = frozenset(env.get("BENCH_PALLAS", "").split(",")) - {""}
    model.pallas = tokens or model.pallas
    return launches_of(model, calls, int(env.get("BENCH_SIZE", SIZE)))


def bench_run(env: dict) -> tuple[dict, dict, float]:
    """``tools/bench.py``'s ``main`` in this process under ``env`` (and
    BENCH_ITERS) with its stdout captured and every launch counter set to 0
    just before and read just after; returns (its one JSON line, the
    launches, seconds)."""
    import io
    import os

    from yolojax_torch.tools import bench

    saved = {k: os.environ.pop(k, None) for k in BENCH_ENV}
    os.environ.update({"BENCH_ITERS": str(BENCH_ITERS), **env})
    counters = launch_counters()
    out = io.StringIO()
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            bench.main()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    lines = out.getvalue().strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench under {env}: printed {lines}, not one line")
    return json.loads(lines[0]), launches, seconds


def fresh_latency(card: str) -> float:
    """``BENCH_MODE=latency python -m yolojax_torch.tools.bench`` in a
    process of its own: its one JSON line's ms per image."""
    import math
    import os

    env = {k: v for k, v in os.environ.items() if k not in BENCH_ENV}
    env.update(BENCH_MODE="latency", BENCH_ITERS=str(BENCH_ITERS))
    proc = subprocess.run([sys.executable, "-m", "yolojax_torch.tools.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    line = json.loads(lines[0]) if proc.returncode == 0 and len(lines) == 1 else {}
    if (line.get("metric") != "yolov2_416_detect_latency_ms" or line.get("device") != card
            or not (math.isfinite(line.get("value", math.nan)) and line["value"] > 0)):
        raise AssertionError(f"bench latency in a fresh process: exit {proc.returncode}, "
                             f"stdout {proc.stdout!r}, stderr {proc.stderr[-2000:]!r}")
    return line["value"]


def bench_phase(card: str) -> tuple[dict, dict]:
    """Phase 16: the port's bench, ``python -m yolojax_torch.tools.bench``,
    under each of BENCH_RUNS in this process, then ``python -m
    yolojax_torch.tools.sustained_bench`` for SUSTAINED_SECONDS.  Each run
    must print one JSON line with ``bench.py``'s metric name, a finite
    positive value, the unit, ``vs_baseline`` and the card, and launch its
    path's kernels once per detect call (2 warm calls + BENCH_ITERS for
    infer, 2 + 100 for latency; train, e2e and pipeline launch none).
    Without OpenCV the e2e and pipeline runs must refuse, naming cv2.  Then
    the latency run again in BENCH_FRESH_LATENCY processes of its own.
    Returns (launches, the phase's line)."""
    import io
    import math
    import shutil

    from yolojax_torch.tools import sustained_bench

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    try:
        import cv2  # noqa: F401
        has_cv2 = True
    except ImportError:
        has_cv2 = False
    total = per_batch()
    runs = {}
    for what, env in BENCH_RUNS:
        mode = env.get("BENCH_MODE", "infer")
        if mode in ("e2e", "pipeline") and not has_cv2:
            try:
                bench_run(env)
            except SystemExit as exc:
                if "cv2" not in str(exc):
                    raise AssertionError(f"bench {what}: refused without naming cv2: {exc}")
                runs[what] = f"not run: OpenCV does not import here ({exc})"
                log(f"[bench] {what}: not run, OpenCV (cv2) does not import on this machine; "
                    "the bench refused, naming it")
                continue
            raise AssertionError(f"bench {what}: ran without OpenCV")
        line, launches, seconds = bench_run(env)
        calls = {"infer": BENCH_WARM_CALLS + BENCH_ITERS,
                 "latency": BENCH_WARM_CALLS + max(BENCH_ITERS, 100)}.get(mode, 0)
        want = bench_launches(env, calls)
        unit = "ms" if mode == "latency" else "images/sec"
        if (line.get("metric") != bench_metric(env) or line.get("unit") != unit
                or not (math.isfinite(line.get("value", math.nan)) and line["value"] > 0)
                or set(line) != {"metric", "value", "unit", "vs_baseline", "device"}
                or line["device"] != card or launches != want):
            raise AssertionError(f"bench {what}: printed {line} (expected {bench_metric(env)}, "
                                 f"{unit}, {card}); launches {launches}, expected {want}")
        runs[what] = {"metric": line["metric"], "value": line["value"], "unit": unit,
                      "launches": {k: v for k, v in launches.items() if v},
                      "seconds": seconds}
        total = summed(total, launches)
        log(f"[bench] {what}: {line['metric']} = {line['value']} {unit} "
            f"(BENCH_ITERS={BENCH_ITERS}); launches {runs[what]['launches'] or 'none'} "
            f"over {calls} detect calls; {seconds:.1f} s")

    # B=1 latency is host-bound, so it reads the host's state: in this
    # process it comes after fifteen phases; a user runs it in a fresh one
    fresh = [fresh_latency(card) for _ in range(BENCH_FRESH_LATENCY)]
    runs["latency darknet 416, fresh processes"] = fresh
    log(f"[bench] latency darknet 416 in {len(fresh)} fresh processes: {fresh} ms "
        f"(BENCH_ITERS={BENCH_ITERS}); in this process "
        f"{runs['latency darknet 416']['value']} ms")

    shutil.rmtree(BENCH_DIR, ignore_errors=True)
    out = BENCH_DIR / "sustained.json"
    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = sustained_bench.main(["--round", "smoke", "--seconds", str(SUSTAINED_SECONDS),
                                   "--out", str(out)])
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    rec = json.loads(out.read_text())
    want = bench_launches({}, BENCH_WARM_CALLS + rec["dispatches"])
    if (rc != 0 or launches != want or rec["metric"] != "sustained_infer_416"
            or [json.loads(line) for line in printed.getvalue().splitlines()] != [rec]
            or not rec["window_rate_p5"] <= rec["window_rate_p50"] <= rec["window_rate_p95"]
            or not rec["value"] > 0 or rec["device"] != card
            or rec["seconds"] < SUSTAINED_SECONDS):
        raise AssertionError(f"sustained bench: exit {rc}, record {rec}, launches {launches} "
                             f"(expected {want})")
    total = summed(total, launches)
    log(f"[bench] sustained {rec['seconds']} s: {rec['value']} img/s over {rec['windows']} "
        f"windows, p5/p50/p95 {rec['window_rate_p5']} / {rec['window_rate_p50']} / "
        f"{rec['window_rate_p95']}, drift {rec['drift_last_vs_first_quartile']}, RSS "
        f"{rec['rss_mb_start']} -> {rec['rss_mb_end']} MB; launches {launches}")
    result = {"card": card, "iters": BENCH_ITERS, "runs": runs,
              "sustained": {k: rec[k] for k in (
                  "value", "seconds", "windows", "dispatches", "window_rate_p5",
                  "window_rate_p50", "window_rate_p95", "drift_last_vs_first_quartile",
                  "rss_mb_start", "rss_mb_end")},
              "seconds": time.perf_counter() - t0}
    log(f"[bench] phase 16 took {result['seconds']:.1f} s")
    return total, result


# -- the last entry points: torchrun across nodes, COCO-80 detect, the bench runner -----

NODES_DIR = ROOT / "build" / "chip_smoke_nodes"   # git-ignored: caches, checkpoints, logs
NODES, NODE_BATCH, NODES_STEPS = 2, 8, 3    # one rank a node on cuda:0, B a rank (the node's)
NODES_TIMEOUT = 600
C80_BATCH, C80_ITERS = 64, 3
BENCH_ALL_JOBS, BENCH_ALL_ITERS = ("LATENCY", "TINY"), 5
RANK_ENV = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "GROUP_RANK")
# the bench command of (c): tools/bench.py's main, counting its launches
BENCH_LAUNCHES = [sys.executable, str(ROOT / "chip_smoke.py"), "--bench-launches"]


def nodes_args(name: str, *argv) -> list:
    """The train CLI's argv for phase 17 (``config.ini``'s Darknet-19, VOC,
    bf16, at SIZE, clip 5, every scalar kept), on the phase's caches, from
    the device-resident dataset: each rank gathers its contiguous rows of
    the global index batch, so the ranks' global batch is one process's row
    for row and each image takes the same augmentation draw.  (The loader
    gives each node ``order[node::nodes]``, as the JAX package gives each
    process: across nodes its global batch holds one process's images in
    another order, so with augmentation on they take other draws.)"""
    return ["--device", TRAIN_DEVICE, "-m", f"config/root={NODES_DIR}", f"model/name={name}",
            f"cache/voc_roots={EVAL_DIR / 'VOC2007'}", "data/device_dataset=1",
            "train/clip=5", "train/prewarm=0",
            f"train/multi_scale_min={SIZE}", f"train/multi_scale_max={SIZE}",
            "summary/scalar=1", "summary/histogram=0", "summary/image=0",
            "save/interval=1e9", *argv]


def nodes_workspace() -> int:
    """Phase 11's 48 PPM images (``EVAL_DIR``) as the ``trainval`` and the
    ``test`` set, their caches written by ``data/cache.py::cache`` under
    NODES_DIR; returns the image count."""
    import shutil

    from yolojax_torch.cli.train import train_parser
    from yolojax_torch.config import load_config
    from yolojax_torch.data.cache import cache

    shutil.rmtree(NODES_DIR, ignore_errors=True)
    sets = EVAL_DIR / "VOC2007" / "ImageSets" / "Main"
    (sets / "trainval.txt").write_text((sets / "test.txt").read_text())
    args = train_parser().parse_args(nodes_args("nodes"))
    built = cache(load_config(args.config, args.modify or ()), phases=("train", "test"))
    if not len(built["train"]) == len(built["test"]) == EVAL_IMAGES:
        raise AssertionError(f"nodes: caches of {len(built['train'])} / {len(built['test'])} "
                             f"images, not {EVAL_IMAGES}")
    return EVAL_IMAGES


def node_rank(spec_path: str) -> None:
    """One rank of phase 17 (``chip_smoke.py --node-rank SPEC`` under
    torchrun): start the gloo group from torchrun's environment (NCCL
    refuses two ranks on one card; ``init_from_env`` takes a group that
    exists), then run SPEC's ``runs`` in turn, each the train or the eval
    CLI's ``main`` with every launch counter set to 0 just before and read
    just after, and a barrier after it (rank 0 writes the checkpoint the
    eval reads); writes what the parent checks beside SPEC."""
    import os

    import torch.distributed as dist

    from yolojax_torch.cli.eval import main as eval_main
    from yolojax_torch.cli.train import main as train_main

    spec = json.loads(Path(spec_path).read_text())
    env = {k: os.environ.get(k) for k in RANK_ENV}
    dist.init_process_group("gloo", init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                            f"{os.environ['MASTER_PORT']}", world_size=int(env["WORLD_SIZE"]),
                            rank=int(env["RANK"]))
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        out = {"env": env}
        for name, cli, argv, *fault in spec["runs"]:
            counters = zero_counters()
            t0 = time.perf_counter()
            with planted(*fault, rank=int(env["RANK"])), float64_config():
                rc = {"train": train_main, "eval": eval_main}[cli](argv)
            out[name] = {"rc": rc, "launches": read_counters(counters) if spec["cuda"] else {},
                         "seconds": time.perf_counter() - t0}
            dist.barrier()
            Path(spec_path).with_name(f"rank{env['RANK']}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def planted(fault: str | None = None, rank: int = 0):
    """A fault planted in a rank for one run of ``--calibrate``, to read what
    phase 17 (a)'s bounds make of it: "double_grad" doubles rank 1's
    gradients before the group averages them; "local_bn" normalises each
    rank with its own share's batch statistics (BN without its sync)."""
    from yolojax_torch.models import blocks
    from yolojax_torch.parallel import collectives, mesh

    saved = mesh.average_grads, blocks.all_reduce_sum
    if fault == "double_grad" and rank == 1:
        mesh.average_grads = lambda grads, group: saved[0](
            {k: {n: 2 * v for n, v in lp.items()} for k, lp in grads.items()}, group)
    elif fault == "local_bn":
        blocks.all_reduce_sum = lambda x, group: x * collectives.world(group)
    elif fault not in (None, "double_grad"):
        raise ValueError(f"planted: no fault {fault!r}")
    try:
        yield
    finally:
        mesh.average_grads, blocks.all_reduce_sum = saved


@contextlib.contextmanager
def float64_config():
    """``[model] dtype`` and ``[transform] dtype`` may say ``float64``, which
    the port's config does not list, for ``--calibrate``'s float64 runs."""
    from yolojax_torch import config

    config._DTYPES["float64"] = torch.float64
    try:
        yield
    finally:
        del config._DTYPES["float64"]


def torchrun_nodes(spec: dict) -> list[dict]:
    """``chip_smoke.py --node-rank`` under NODES launchers of ``python -m
    torch.distributed.run --nnodes NODES --nproc-per-node 1 --node-rank i``
    on this host; returns each rank's record, in rank order.  The
    launchers run in sessions of their own, so a failure or a timeout stops
    their ranks too."""
    import importlib.util
    import os
    import signal

    from yolojax_torch.parallel.collectives import _free_port

    spec_path = NODES_DIR / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if importlib.util.find_spec("cv2") is None:
        env["PYTHONPATH"] += os.pathsep + str(EVAL_DIR / "stub")
    port = _free_port()
    logs = [NODES_DIR / f"node{i}.log" for i in range(NODES)]
    procs = []
    try:
        for i, log_path in enumerate(logs):
            with open(log_path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(NODES),
                     "--nproc-per-node", "1", "--node-rank", str(i), "--master-addr",
                     "127.0.0.1", "--master-port", str(port), str(ROOT / "chip_smoke.py"),
                     "--node-rank", str(spec_path)],
                    cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                    start_new_session=True))
        deadline = time.monotonic() + NODES_TIMEOUT
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    if rcs != [0] * NODES:
        for log_path in logs:
            log(log_path.read_text()[-4000:])
        raise AssertionError(f"nodes: the torchrun launchers exited {rcs}")
    return [json.loads((NODES_DIR / f"rank{r}.json").read_text()) for r in range(NODES)]


def parity_recipe(name: str, *argv) -> list:
    """(a)'s f32 run: ``nodes_args`` in float32 with phase 13 (a)'s sgd
    (``tests/test_torch_train_step.py``'s: BN-γ sparsity 0.01, a milestone
    at step 2), under which ``DIST_PARITY`` was set.

    What ``--calibrate`` read on the H100 at SIZE, B=NODE_BATCH a rank: under
    this sgd the params' change lies 1.27e-2 from one process's.  Under
    config.ini's recipe it lies 2.45e-2 away in float32, and 3.6e-6 in
    float64, where the components' gap stays near 8e-8 at each step while in
    float32 it grows 2.7e-6 → 1.2e-4 → 3.5e-3: float32 rounding (B=8 and
    B=16 sums) that the recipe's full-rate steps amplify, not a fault of the
    split.  Planted faults read far outside the bounds: a rank whose
    gradient is doubled 0.34 on the change (0.42 at step 1), BN without its
    sync 1.18 (0.31 at step 1)."""
    return nodes_args(name, "-m", "model/dtype=float32", "transform/dtype=float32",
                      "train/milestones=2", "train/gamma=0.1", "train/sparsity=0.01", *argv)


def one_process(argv: list) -> tuple[dict, dict]:
    """``Train`` in this process on the train CLI's ``argv`` under
    deterministic cuDNN: ({rows, params, state, trace, seen,
    steps_per_epoch}, the start params), on the CPU."""
    from yolojax_torch.cli import setup
    from yolojax_torch.cli.train import Train, train_parser

    cpu = lambda tree: {k: {n: v.cpu() for n, v in lp.items()} for k, lp in tree.items()}
    args = train_parser().parse_args(argv)
    config = setup(args)
    torch.backends.cudnn.deterministic = True
    try:
        one = Train(args, config)
        start = cpu({k: {n: v.clone() for n, v in lp.items()} for k, lp in one.params.items()})
        one(max_steps=args.steps)
    finally:
        torch.backends.cudnn.deterministic = False
    return ({"rows": scalar_rows(config), "params": cpu(one.params), "state": cpu(one.state),
             "trace": cpu(one.opt_state["trace"]), "seen": one.seen,
             "steps_per_epoch": one.steps_per_epoch}, start)


def nodes_checkpoint(argv: list) -> tuple[dict, dict]:
    """The last checkpoint of the ranks' run on the train CLI's ``argv``
    (rank 0's): ({rows, params, state, trace}, its meta)."""
    from yolojax_torch.cli import setup
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.train import train_parser
    from yolojax_torch.config import get_model_dir
    from yolojax_torch.utils import checkpoint as ckpt

    config = setup(train_parser().parse_args(argv))
    path = Path(get_model_dir(config)) / f"{NODES_STEPS}.npz"
    params, state, meta = load_weights_auto(config, build(config)[2], str(path))
    trace = {k: {n: torch.from_numpy(v) for n, v in lp.items()}
             for k, lp in ckpt.load(str(path), ("opt",))[0]["opt"]["trace"].items()}
    return {"rows": scalar_rows(config), "params": params, "state": state, "trace": trace}, meta


def step_gaps(got_rows: list, want_rows: list) -> list:
    """The components' and grad_norm's largest relative gap at each step."""
    return [max(abs(g[k] - w[k]) / abs(w[k]) for k in COMPONENTS)
            for g, w in zip(got_rows, want_rows)]


def nodes_run(card: str) -> tuple[dict, dict]:
    """(a) the train CLI, then the eval CLI, launched by torchrun as two
    nodes of one rank each on ``cuda:0``: torchrun's environment on each
    rank; the bf16 run (config.ini's recipe) every loss finite, ``step`` and
    ``seen``, no kernel launched; the f32 run's rank-0 checkpoint against
    ``Train`` in this process at the global batch (the same start, data and
    draws, deterministic cuDNN, TF32 off) within ``DIST_PARITY``, and that
    run against itself run again for scale; the eval of the bf16 checkpoint
    split over the nodes, one fused decode+NMS a batch of each rank's
    share.  Returns (launches, numbers)."""
    from yolojax_torch.cli import setup
    from yolojax_torch.cli.train import train_parser
    from yolojax_torch.config import get_model_dir
    from yolojax_torch.utils import checkpoint as ckpt

    images = nodes_workspace()
    global_batch = NODE_BATCH * NODES
    steps = ["--batch", str(NODE_BATCH), "--steps", str(NODES_STEPS)]
    spec = {"cuda": TRAIN_DEVICE == "cuda", "runs": [
        ["train", "train", nodes_args("nodes", *steps)],
        ["parity", "train", parity_recipe("nodes-f32", *steps)],
        ["eval", "eval", ["-m", f"config/root={NODES_DIR}", "model/name=nodes",
                          f"cache/voc_roots={EVAL_DIR / 'VOC2007'}", "--size", str(SIZE),
                          "--batch", str(global_batch), "--device", TRAIN_DEVICE,
                          "--results", str(NODES_DIR / "dets.jsonl")]]]}
    t0 = time.perf_counter()
    ranks = torchrun_nodes(spec)
    ranks_s = time.perf_counter() - t0
    batches = -(-EVAL_IMAGES // global_batch)
    want_launches = {"train": per_batch(), "parity": per_batch(),
                     "eval": launches_of(model_of(darknet_config()), batches)}
    for r, rec in enumerate(ranks):
        want_env = {"RANK": str(r), "LOCAL_RANK": "0", "WORLD_SIZE": str(NODES),
                    "LOCAL_WORLD_SIZE": "1", "GROUP_RANK": str(r)}
        if rec["env"] != want_env or any(rec[k]["rc"] != 0 for k in want_launches):
            raise AssertionError(f"nodes: rank {r} saw {rec['env']} (expected {want_env}), "
                                 f"{rec}")
        if spec["cuda"] and any(rec[k]["launches"] != v for k, v in want_launches.items()):
            raise AssertionError(f"nodes: rank {r} launched {rec}; expected {want_launches}")

    seen = global_batch * NODES_STEPS
    config = setup(train_parser().parse_args(nodes_args("nodes")))
    rows = [r for r in scalar_rows(config) if "total" in r]   # the eval adds its eval/mAP row
    _, meta = ckpt.load(str(Path(get_model_dir(config)) / f"{NODES_STEPS}.npz"), ())
    bad = [(r["step"], k) for r in rows for k in COMPONENTS if not np.isfinite(r[k])]
    if len(rows) != NODES_STEPS or bad or meta != {"step": NODES_STEPS, "seen": seen}:
        raise AssertionError(f"nodes: the bf16 run wrote {len(rows)} rows, non-finite {bad}, "
                             f"meta {meta}")

    one_argv = lambda name: parity_recipe(name, "--batch", str(global_batch), "--steps",
                                          str(NODES_STEPS))
    want, start = one_process(one_argv("nodes-f32-one"))
    again, _ = one_process(one_argv("nodes-f32-one-again"))
    got, f32_meta = nodes_checkpoint(parity_recipe("nodes-f32"))
    errs = parity_errs(got, want, start)
    again = parity_errs(again, want, start)
    fmt = lambda e: (f"components and grad_norm max rel diff {e['first']:.3g} at step 1, "
                     f"{e['later']:.3g} after; params' change {e['change']:.3g}, momentum "
                     f"{e['trace']:.3g}, BN state {e['state']:.3g}")
    log(f"[nodes] (a) {card} | python -m torch.distributed.run --nnodes {NODES} "
        f"--nproc-per-node 1 chip_smoke.py --node-rank: the train CLI on {NODES} nodes of one "
        f"rank (gloo, cuda:0), B={NODE_BATCH} a rank, {NODES_STEPS} steps of Darknet-19 at "
        f"{SIZE}, the device-resident dataset: bf16 (config.ini's recipe) total "
        f"{rows[0]['total']:.4g} → {rows[-1]['total']:.4g}, every loss finite, seen "
        f"{meta['seen']}; f32 (TF32 off, deterministic cuDNN) against one process at "
        f"B={global_batch}: {fmt(errs)} (bounds {DIST_PARITY}); seen {f32_meta.get('seen')} "
        f"(one process {want['seen']}), {want['steps_per_epoch']} steps an epoch of {images} "
        f"images; {ranks_s:.1f} s for both launches with start-up")
    log(f"[nodes] (a) for scale, the one-process run against itself run again: {fmt(again)}")
    if ({len(got["rows"]), len(want["rows"])} != {NODES_STEPS} or want["seen"] != seen
            or f32_meta.get("seen") != seen or any(errs[k] > DIST_PARITY[k] for k in errs)):
        raise AssertionError(f"nodes (a): {len(got['rows'])} / {len(want['rows'])} scalar rows, "
                             f"meta {f32_meta}, seen {want['seen']} (expected {seen}), {errs}")

    launches = dict.fromkeys(KERNELS, 0)
    for rec in ranks:
        launches = {k: launches[k] + rec["eval"]["launches"].get(k, 0) for k in KERNELS}
    printed = [line for line in (NODES_DIR / "node0.log").read_text().splitlines()
               if line.startswith("mAP = ")]
    dets = (NODES_DIR / "dets.jsonl").read_text().splitlines()
    if len(printed) != 1 or not dets:
        raise AssertionError(f"nodes: the eval printed {printed}, {len(dets)} detections")
    log(f"[nodes] (a) the eval CLI on the same {NODES} nodes, the bf16 checkpoint, "
        f"{global_batch // NODES} images a rank of each batch of {global_batch}: "
        f"'{printed[0]}', {len(dets)} detections; launches per rank "
        f"{[rec['eval']['launches'] for rec in ranks]} (one fused a batch); seconds a rank "
        f"{[{k: round(rec[k]['seconds'], 1) for k in want_launches} for rec in ranks]}")
    return launches, {**errs, "one_process_again": again, "seen": meta["seen"],
                      "bf16_total": [rows[0]["total"], rows[-1]["total"]],
                      "eval": printed[0], "seconds": ranks_s}


def c80_vs_plain() -> dict:
    """(b)'s kernels against their plain versions at the shape the tool gives
    them: B=C80_BATCH images through the 80-class Darknet-19 with the
    weights' own objectness logit (about 0, a dense head where hundreds of
    thousands of boxes are kept), bf16, at SIZE.  The fused kernel on the raw
    head against ``ops/postprocess.py::postprocess_raw`` (``compare``: keep
    identical, conf to rtol 2e-5, corners to 1e-5); nms_select on the
    decoded head against ``ops/nms.py::nms_select`` (idx, conf, valid
    identical) and ``postprocess_nms`` against ``postprocess``.  These
    comparison launches (one fused, two nms_select) are counted in their own
    window and kept out of the phase's.  Returns each kernel's largest abs
    error."""
    from yolojax_torch.kernels.nms import nms_select, postprocess_nms
    from yolojax_torch.kernels.postprocess_fused import postprocess_fused
    from yolojax_torch.ops.decode import decode
    from yolojax_torch.ops.nms import nms_select as nms_plain
    from yolojax_torch.ops.postprocess import postprocess, postprocess_raw
    from yolojax_torch.tools import c80_fusedpost as c80

    model, folded, _ = c80.setup(TRAIN_DEVICE, objectness=None)
    point = (c80.THRESHOLD, c80.OVERLAP, c80.TOPK)
    with torch.inference_mode():
        raw = model.apply_folded(folded, seeded_images(80, C80_BATCH))
        anchors = torch.as_tensor(model.anchors, dtype=torch.float32, device=raw.device)
        det = decode(raw, anchors)
        boxes = (det.yx_min[:, None], det.yx_max[:, None], det.conf.transpose(1, 2))
        counters = zero_counters()
        fused, picks = postprocess_fused(raw, anchors, *point), nms_select(*boxes, *point)
        separate = postprocess_nms(det, *point)
        launches = read_counters(counters)
        plain_raw, plain_picks = postprocess_raw(raw, anchors, *point), nms_plain(*boxes, *point)
        plain = postprocess(det, *point)
    want = per_batch(postprocess_fused=1, nms_select=2)
    if launches != want:
        raise AssertionError(f"c80 vs plain: launched {launches}, expected {want}")
    what = f"({C80_BATCH},{raw.shape[1]},{raw.shape[2]},{raw.shape[3]}) bf16 dense"
    err = {"postprocess_fused": compare(fused, plain_raw, c80.CLASSES, f"c80 fused {what}")}
    for g, v, part in zip(picks, plain_picks, ("idx", "conf", "valid")):
        if g.shape != v.shape or g.dtype != v.dtype or not torch.equal(g, v):
            raise AssertionError(f"c80 nms_select {what}: {part} differs from the plain version")
    err["nms_select"] = compare(separate, plain, c80.CLASSES, f"c80 postprocess_nms {what}")
    log(f"[c80] {what}: the fused kernel matches postprocess_raw ({int(plain_raw.keep.sum())} "
        f"kept), nms_select is identical to the plain version ({int(plain_picks[2].sum())} "
        f"picks), postprocess_nms matches postprocess; longest compacted row "
        f"{compacted(det)} of {det.conf.shape[1]}; max abs err {err}")
    return err


def c80_run(card: str) -> tuple[dict, dict]:
    """(b) ``python -m yolojax_torch.tools.c80_fusedpost``'s ``main`` in this
    process at B=C80_BATCH, C80_ITERS calls a route: one JSON line with the
    card, both routes' times, bounds and device times; every call of the
    fused route launches one postprocess_fused and no nms_select, every
    call of the separate route the reverse; with every launch counter set
    to 0 just before and read just after, the whole run launched what its
    calls and its kernel timings call for; then a CUDA graph capture of one
    call of each route holds exactly one kernel of its post-processing.
    Returns (launches, numbers)."""
    import io

    from yolojax_torch.entry import flagship
    from yolojax_torch.tools import c80_fusedpost

    counters = zero_counters()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = c80_fusedpost.main(["--batches", str(C80_BATCH), "--iters", str(C80_ITERS),
                                 "--size", str(SIZE), "--device", TRAIN_DEVICE])
    launches = read_counters(counters)
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    row = line["batches"][str(C80_BATCH)]
    # a route's calls: first, warm, C80_ITERS timed; its post kernel alone: one for the
    # bound, 3 warm + 7 timed, and on a card 1 + 5 profiled (and one between CUDA
    # events where the profiler recorded none); one on the dense head
    per_call = {"fused": {"postprocess_fused": 1, "nms_select": 0},
                "separate": {"postprocess_fused": 0, "nms_select": 1}}
    calls = {c80_fusedpost.KERNELS[r]: 2 + C80_ITERS + 1 + 10 + 1 + (
        6 + row[r]["post_device_how"].startswith("CUDA events") if TRAIN_DEVICE == "cuda" else 0)
        for r in per_call}
    # forwards: a route's first, warm and timed calls and its post kernel's head, and
    # one a route on the dense head
    forwards = 2 * (3 + C80_ITERS) + 2
    model = flagship(num_classes=c80_fusedpost.CLASSES)
    want = summed(per_batch(**calls), launches_of(model, forwards, post=False))
    dense = row["same_boxes_init_objectness"]
    if (rc != 0 or line["device"] != card or launches != want
            or any(row[r]["launches_per_call"] != per_call[r] for r in per_call)
            or not all(row[r]["ms"] > 0 and row[r]["bound_ms"] > 0 for r in per_call)
            or not (dense["same_keep"] and dense["kept_fused"] > 0)):
        raise AssertionError(f"c80: exit {rc}, line {line}, launches {launches} (expected {want})")

    from yolojax_torch.kernels.nms import postprocess_nms
    from yolojax_torch.models.inference import Inference

    # a graph capture of one fused call, and of the separate route's post stage on
    # its decoded head (the decode copies the grid's size to the card, which a
    # capture refuses)
    model, folded, routes = c80_fusedpost.setup(TRAIN_DEVICE)
    x = seeded_images(80, C80_BATCH)
    with torch.inference_mode():
        det = Inference(model)(folded, x)
    one_call = {"fused": lambda: routes["fused"](folded, x),
                "separate": lambda: postprocess_nms(det, c80_fusedpost.THRESHOLD,
                                                    c80_fusedpost.OVERLAP, c80_fusedpost.TOPK)}
    for route, call in one_call.items():
        with torch.inference_mode():
            call()
            work = captured_work(call)
        mine = {k: sum(k in w for w in work) for k in ("postprocess_fused", "nms_select")}
        if mine != per_call[route]:
            raise AssertionError(f"c80: one {route} call put {mine} on the stream, expected "
                                 f"{per_call[route]}")
        log(f"[c80] one {route} call (B={C80_BATCH}) in a CUDA graph capture: {len(work)} "
            f"nodes, {mine}")
    del model, folded, routes, det
    for route in per_call:
        r = row[route]
        log(f"[c80] {card} | B={C80_BATCH}, 80 classes, {SIZE}, bf16, {route}: first call "
            f"{r['first_s']:.2f} s, {r['ms']:.2f} ms = {r['img_per_s']:.1f} img/s over "
            f"{C80_ITERS} calls; {r['post_kernel']} alone {r['post_ms']:.4f} ms, device "
            f"{r['post_device_us']} us, bound {r['bound_ms']:.5f} ms by {r['bound_by']}")
    log(f"[c80] same boxes: {row['same_boxes']}; with the init's objectness {dense}; "
        f"launches {launches}")
    return launches, {"batch": C80_BATCH, "row": row, "max_abs_err": c80_vs_plain()}


CALIBRATE_SEEDS = 6
CALIBRATE_FAULTS = ("double_grad", "local_bn")


def calibrate(card: str) -> None:
    """``chip_smoke.py --calibrate``: the readings two of the run's bounds
    rest on; checks nothing.  (1) Phase 17 (a): the two torchrun nodes'
    train CLI (B=NODE_BATCH a rank, NODES_STEPS steps at SIZE, deterministic
    cuDNN, TF32 off) against ``Train`` in this process at the global batch,
    under config.ini's recipe in float32 and in float64 and under the sgd of
    ``parity_recipe``, and under that sgd with each planted fault
    (``planted``) against the faultless one process; ``parity_errs`` and the
    components' gap at each step.  (2) Phase 14's overfit: CALIBRATE_SEEDS
    values of ``[train] seed`` for half OVERFIT_STEPS (the reference
    test's 600) and OVERFIT_STEPS under the default algorithms and for half
    under the deterministic ones.  Prints one JSON line."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    eval_workspace()
    nodes_workspace()
    global_batch = NODE_BATCH * NODES
    mods = {"cfg-f32": ["-m", "model/dtype=float32", "transform/dtype=float32"],
            "cfg-f64": ["-m", "model/dtype=float64", "transform/dtype=float64"]}
    recipe = {"cfg-f32": lambda name, *a: nodes_args(name, *mods["cfg-f32"], *a),
              "cfg-f64": lambda name, *a: nodes_args(name, *mods["cfg-f64"], *a),
              "sgd-f32": parity_recipe}
    runs = [[name, "train", fn(name, "--batch", str(NODE_BATCH), "--steps", str(NODES_STEPS))]
            for name, fn in recipe.items()]
    runs += [[f"sgd-f32-{fault}", "train", parity_recipe(
        f"sgd-f32-{fault}", "--batch", str(NODE_BATCH), "--steps", str(NODES_STEPS)), fault]
        for fault in CALIBRATE_FAULTS]
    t0 = time.perf_counter()
    torchrun_nodes({"cuda": TRAIN_DEVICE == "cuda", "runs": runs})
    out = {"card": card, "ranks_s": time.perf_counter() - t0, "parity": {}, "overfit": {}}
    ones = {}
    for name, fn in recipe.items():
        with float64_config():
            ones[name] = one_process(fn(f"{name}-one", "--batch", str(global_batch), "--steps",
                                        str(NODES_STEPS)))
            got, _ = nodes_checkpoint(fn(name))
        (want, start) = ones[name]
        out["parity"][name] = {**parity_errs(got, want, start),
                               "steps": step_gaps(got["rows"], want["rows"])}
    for fault in CALIBRATE_FAULTS:
        got, _ = nodes_checkpoint(parity_recipe(f"sgd-f32-{fault}"))
        want, start = ones["sgd-f32"]
        out["parity"][f"sgd-f32-{fault}"] = {**parity_errs(got, want, start),
                                             "steps": step_gaps(got["rows"], want["rows"])}
    for name, errs in out["parity"].items():
        log(f"[calibrate] {card} | nodes (a) {name}: {errs} (bounds {DIST_PARITY})")

    for steps, deterministic in ((OVERFIT_STEPS // 2, False), (OVERFIT_STEPS, False),
                                 (OVERFIT_STEPS // 2, True)):
        key = f"{steps} {'deterministic' if deterministic else 'default'}"
        out["overfit"][key] = []
        for seed in range(CALIBRATE_SEEDS):
            run = overfit_run(TRAIN_DEVICE, steps, seed, deterministic)
            out["overfit"][key].append({"seed": seed, "map": run["map"],
                                        "ap": list(run["ap"].values()),
                                        "train_s": run["train_s"]})
            log(f"[calibrate] {card} | overfit {key}, seed {seed}: mAP@0.3 {run['map']:.6f}, "
                f"per class {run['ap']}, {run['train_s']:.1f} s")
    print(json.dumps({"calibrate": out}), flush=True)


def counted_bench() -> None:
    """``chip_smoke.py --bench-launches``: ``tools/bench.py``'s ``main`` (its
    one JSON line on stdout) with every launch counter set to 0 just before
    and read just after, the counts as a JSON line on stderr, which
    ``tools/bench_all.py`` folds into the artifact's diagnostics."""
    from yolojax_torch.tools import bench

    counters = zero_counters()
    bench.main()
    print(json.dumps({"launches": read_counters(counters)}), file=sys.stderr, flush=True)


def bench_all_run(card: str) -> tuple[dict, dict]:
    """(c) ``python -m yolojax_torch.tools.bench_all --only LATENCY TINY`` in
    this process at BENCH_ITERS=BENCH_ALL_ITERS, each job's bench run as
    ``chip_smoke.py --bench-launches`` (the bench counting its launches):
    one artifact a job with the card and the launches its route gives a
    detect call (2 warm calls and max(iters, 100) at B=1, 2 + iters for
    Tiny).  Returns
    (launches, numbers)."""
    import io
    import os

    from yolojax_torch.tools import bench_all

    out_dir = NODES_DIR / "bench_torch"
    saved = (bench_all.BENCH, bench_all.OUT_DIR, os.environ.get("BENCH_ITERS"))
    bench_all.BENCH = BENCH_LAUNCHES
    bench_all.OUT_DIR = out_dir
    os.environ["BENCH_ITERS"] = str(BENCH_ALL_ITERS)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            rc = bench_all.main(["--round", "smoke", "--only", *BENCH_ALL_JOBS])
    finally:
        bench_all.BENCH, bench_all.OUT_DIR = saved[:2]
        os.environ.pop("BENCH_ITERS")
        if saved[2] is not None:
            os.environ["BENCH_ITERS"] = saved[2]
    jobs = dict(bench_all.JOBS)
    want = {"LATENCY": bench_launches(jobs["LATENCY"], BENCH_WARM_CALLS + max(BENCH_ALL_ITERS,
                                                                               100)),
            "TINY": bench_launches(jobs["TINY"], BENCH_WARM_CALLS + BENCH_ALL_ITERS)}
    launches, numbers = per_batch(), {}
    for tag in BENCH_ALL_JOBS:
        path = out_dir / f"BENCH_{tag}_rsmoke.json"
        rec = json.loads(path.read_text()) if path.exists() else {}
        got = [d["launches"] for d in rec.get("diagnostics", []) if "launches" in d]
        if rc != 0 or rec.get("device") != card or got != [want[tag]]:
            raise AssertionError(f"bench_all {tag}: exit {rc}, artifact {rec}; printed "
                                 f"{printed.getvalue()[-2000:]}")
        launches = summed(launches, got[0])
        numbers[tag] = {"metric": rec["metric"], "value": rec["value"]}
        log(f"[bench_all] {tag}: {rec['metric']} = {rec['value']} {rec['unit']} "
            f"(BENCH_ITERS={BENCH_ALL_ITERS}) -> {path.relative_to(ROOT)}; launches {got[0]}")
    return launches, numbers


def nodes_phase(card: str) -> tuple[dict, dict]:
    """Phase 17: (a) the train and eval CLIs launched by torchrun as two
    nodes, (b) COCO-80 detect fused against separate, (c) the bench runner.
    Returns (launches, the phase's line)."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    nodes_launches, nodes = nodes_run(card)
    c80_launches, c80 = c80_run(card)
    runner_launches, bench_all_numbers = bench_all_run(card)
    result = {"card": card, "nodes": nodes, "c80": c80, "bench_all": bench_all_numbers,
              "seconds": time.perf_counter() - t0}
    log(f"[nodes] phase 17 took {result['seconds']:.1f} s")
    return ({k: nodes_launches[k] + c80_launches[k] + runner_launches[k] for k in KERNELS},
            result)


# phase 18: YOLO9000's head at 544 (N = 17*17*3 boxes of 5 + 9418 channels)
TREE_GRID, TREE_ANCHORS, TREE_CLASSES = 17, 3, 9418
TREE_BATCHES = (8, 128)
TREE_SCORE_RTOL = 2.4e-7
# the main path's batches, and its random head made to pick: the class rows scaled
# so walks go a few groups deep (at gain 1 they stop in the root groups) and the
# objectness bias that leaves scores over THRESHOLD
YOLO9000_BATCHES = (8, 8, 128)
YOLO9000_CLASS_GAIN, YOLO9000_OBJECTNESS = 8.0, -2.5
HEAD_CONV_BATCH = 128       # the bench cell's batch, for the head conv's times


def tree_head(b: int, seed: int) -> torch.Tensor:
    """A seeded bf16 YOLO9000 head on the card: box logits N(0, 1),
    objectness N(-4, 2), class logits N(0, 8) (confident groups: walks go
    deep)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    per = 5 + TREE_CLASSES
    x = torch.randn((b, TREE_GRID, TREE_GRID, TREE_ANCHORS, per), generator=g, device="cuda")
    x[..., 4] = x[..., 4] * 2 - 4
    x[..., 5:] *= 8
    return x.to(torch.bfloat16).view(b, TREE_GRID, TREE_GRID, -1)


def tree_check(got, want, what: str) -> float:
    """The tree kernels' picks ``got`` against the plain version's ``want``
    (TreePostProcessed): keep, nodes and kept corners identical, kept scores
    within TREE_SCORE_RTOL.  Returns the largest abs score error."""
    keep = got.keep
    if not (torch.equal(keep, want.keep) and torch.equal(got.node, want.node)
            and torch.equal(got.yx_min[keep], want.yx_min[keep])
            and torch.equal(got.yx_max[keep], want.yx_max[keep])):
        raise AssertionError(f"{what}: picks differ from the plain version's")
    if not keep.any():
        return 0.0
    diff = (got.score - want.score).abs()[keep]
    rel = float((diff / want.score.abs()[keep].clamp(min=1e-30)).max())
    if rel > TREE_SCORE_RTOL:
        raise AssertionError(f"{what}: scores {rel:.3g} apart, over {TREE_SCORE_RTOL}")
    return float(diff.max())


def yolo9000_config(dtype: str = "bfloat16"):
    from yolojax_torch.config import load_config

    return load_config([str(ROOT / "config.ini"), str(ROOT / "config" / "yolo9000.ini")],
                       [f"model/dtype={dtype}"])


def yolo9000_path() -> tuple[dict, dict, float]:
    """Phase 18 (a), the YOLO9000 main path (module docstring).  Returns
    (launches, numbers, largest abs score error)."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.detect import detect_image
    from yolojax_torch.models.inference import Inference
    from yolojax_torch.ops.tree import tree_postprocess

    config = yolo9000_config()
    category, anchors, model = build(config)
    size = int(config.get("data", "sizes").split(",")[0])
    params, state, _ = load_weights_auto(config, model, rng_seed=0, device="cuda")
    per = 5 + model.num_classes
    params["out"]["w"].view(len(anchors), per, -1)[:, 5:] *= YOLO9000_CLASS_GAIN
    params["out"]["b"].view(-1, per)[:, 4] = YOLO9000_OBJECTNESS
    inference = Inference(model)
    folded = inference.fold(params, state)
    run = inference.detect_fn(THRESHOLD, OVERLAP, TOPK)
    log(f"[yolo9000] {type(model).__name__} {size}x{size}, {len(category)} tree nodes, "
        f"{len(anchors)} anchors, {model.dtype}, kernels {sorted(model.pallas)}, head "
        f"{model.out_channels} channels")

    rng = np.random.default_rng(3)
    batches = [torch.from_numpy(rng.uniform(0, 1, (b, size, size, 3)).astype(np.float32))
               .to("cuda") for b in YOLO9000_BATCHES]
    forward, heads = model.apply_folded, []

    def kept(*args):    # the forward, keeping the raw head each call decodes
        heads.append(forward(*args))
        return heads[-1]

    counters = launch_counters()
    for fn in counters.values():
        fn.launches = 0
    model.apply_folded = kept
    try:
        outs = [run(folded, x) for x in batches]
    finally:
        del model.apply_folded
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = launches_of(model, len(batches), size)
    if launches != want:
        raise AssertionError(f"yolo9000: {len(batches)} batches launched {launches}, "
                             f"expected {want}")
    anchors_t = torch.as_tensor(anchors, device="cuda")
    err, result = 0.0, {}
    for i, (x, raw, out) in enumerate(zip(batches, heads, outs)):
        b, what = len(x), f"yolo9000 batch {i} (B={len(x)})"
        if raw.shape != (b, size // 32, size // 32, model.out_channels):
            raise AssertionError(f"{what}: raw head {tuple(raw.shape)}")
        if out.node.shape != (b, TOPK) or out.yx_min.shape != (b, TOPK, 2):
            raise AssertionError(f"{what}: output shape {tuple(out.node.shape)}")
        plain = tree_postprocess(raw, anchors_t, model.tree, THRESHOLD, OVERLAP, TOPK,
                                 model.hier_thresh)
        err = max(err, tree_check(out, plain, what))
        picks = out.keep.sum(-1)
        if not picks.min() > 0:
            raise AssertionError(f"{what}: an image with no pick to compare")
        depth = [model.tree.depth[n] for n in out.node[out.keep].tolist()]
        result[f"batch{i}"] = {"b": b, "picks": int(picks.sum()),
                               "nodes": int(out.node[out.keep].unique().numel()),
                               "node_depth_mean": float(np.mean(depth))}
        log(f"[{what}] picks match ops/tree.py on the raw head it decoded: "
            f"{result[f'batch{i}']}")
    del heads, outs
    raw_vs_without(model, folded, yolo9000_config, set(), "yolo9000", exact=True, size=size)
    image = np.random.default_rng(2).integers(0, 256, (480, 640, 3), dtype=np.uint8)
    ymin, ymax, node, conf = detect_image(config, model, params, state, image, size)
    if not (ymin.shape == ymax.shape == (len(node), 2) and len(conf) == len(node)
            and np.isfinite(conf).all() and ((node >= 0) & (node < len(category))).all()):
        raise AssertionError("yolo9000: detect_image returned malformed detections")
    log(f"[yolo9000] detect_image on a 480x640 image returned {len(node)} detections, "
        f"first {[category[n] for n in node[:3].tolist()]}")
    log(f"[yolo9000] detect_fn ran {len(batches)} batches; launches {launches}")
    return launches, result, err


def tree_phase(card: str) -> tuple[dict, float]:
    """Phase 18 (b) (module docstring): the tree kernels against their plain
    version at B=8 and B=128, their times and bound.  Returns (numbers,
    largest abs score error)."""
    from yolojax_torch.entry import flagship
    from yolojax_torch.kernels import tree as tk
    from yolojax_torch.ops.tree import tree_decode, tree_postprocess

    model = flagship(backbone="yolo9000")
    tree = model.tree
    anchors = torch.as_tensor(model.anchors, device="cuda")
    result, err = {"card": card}, 0.0
    for b in TREE_BATCHES:
        raw = tree_head(b, 18 + b)
        args = (anchors, tree, THRESHOLD, OVERLAP, TOPK)
        counts, launches = tk.counters(), tk.tree_decode.launches
        got = tk.tree_decode(raw, *args, model.hier_thresh)
        if tk.tree_decode.launches != launches + 2:
            raise AssertionError(f"tree: {tk.tree_decode.launches - launches} launches a call")
        want = tree_postprocess(raw, *args, model.hier_thresh)
        err = max(err, tree_check(got, want, f"tree: B={b}"))
        _, _, _, _, visited = tree_decode(raw, anchors, tree, model.hier_thresh)
        after = tk.counters()
        if (after["tree_walks"] - counts["tree_walks"] != visited.numel()
                or after["tree_groups_visited"] - counts["tree_groups_visited"]
                != int(visited.sum())):
            raise AssertionError(f"tree: B={b}: the walk counters {after} miss the plain walk's")
        kernel = lambda: tk.tree_decode(raw, *args, model.hier_thresh)
        plain = lambda: tree_postprocess(raw, *args, model.hier_thresh)
        plain_ms, kernel_ms = in_turns(plain, kernel)
        device_us = graph_us(kernel, 10)
        bound = Bound().add(nbytes(raw) + b * TOPK * 25)
        result[b] = {"picks": int(got.keep.sum()), "score_abs_err": err,
                     "groups_a_walk": float(visited.float().mean()), "ms": kernel_ms,
                     "plain_ms": plain_ms, "device_us": device_us, "bound_ms": bound.total,
                     "bound_by": bound.by, "of_bound": bound.total * 1e3 / device_us}
        log(f"[tree] B={b}: {result[b]}")
        del raw, got, want
    return result, err


def head_conv_times(card: str) -> dict:
    """Phase 18 (c): YOLO9000's 1×1 head conv alone (``blocks.conv``, i.e.
    cuDNN) on a seeded (HEAD_CONV_BATCH, 1024, 17, 17) ``channels_last``
    bf16 input, at its own width and at the padded width the engine runs it
    at (``engine.padded_width``): the kernels cuDNN launches (a CUDA graph
    capture), a call's device ms in a CUDA graph of calls, and the bound
    (2 · pixels · 1024 · width FLOPs at the bf16 peak, or the bytes).  The
    two outputs' first 28 269 channels are two kernels' sums of the same
    products: their largest difference is printed, not held to 0."""
    from yolojax_torch.models import LayerDef
    from yolojax_torch.models.blocks import conv
    from yolojax_torch.models.engine import padded_width

    c = TREE_ANCHORS * (5 + TREE_CLASSES)
    pad = padded_width(LayerDef("out", c, 1, in_ch=1024))
    g = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((HEAD_CONV_BATCH, 1024, TREE_GRID, TREE_GRID), generator=g,
                    device="cuda").to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    w = (torch.randn((pad, 1024, 1, 1), generator=g, device="cuda") * 0.03).to(torch.bfloat16)
    w[c:] = 0
    result, outs = {}, {}
    for width in (c, pad):
        wc = w[:width].contiguous(memory_format=torch.channels_last)
        fn = lambda: conv(x, wc)
        outs[width] = fn()[:, :c]
        kernels = [k for k in captured_work(fn) if not k.startswith("<")]
        ms = graph_us(fn, 4) / 1e3
        bound = Bound().add(nbytes(x, wc) + x.numel() // 1024 * width * 2,
                            {"bf16 tensor": 2 * x.numel() * width})
        result[width] = {"kernels": kernels, "device_ms": ms, "bound_ms": bound.total,
                         "bound_by": bound.by, "of_bound": bound.total / ms,
                         "tflops": 2 * x.numel() * width / ms / 1e9}
        log(f"[head conv] {card} | (B={HEAD_CONV_BATCH}, 17, 17, 1024) -> {width} bf16: "
            f"{kernels}, device {ms:.4f} ms a call in a graph of 4, "
            f"{result[width]['tflops']:.1f} TFLOP/s, {100 * result[width]['of_bound']:.1f} % of "
            f"its bound {bound.total:.4f} ms ({bound.by})")
    diff = float((outs[c].float() - outs[pad].float()).abs().max())
    result["max_abs_diff"] = diff
    log(f"[head conv] the padded conv's first {c} channels against the unpadded conv's: "
        f"max abs diff {diff:.4g}")
    return result


def tree_paths(card: str) -> tuple[dict, dict, float]:
    """Phase 18: (a), (b), then (c).  Returns (the main path's launches,
    numbers, largest abs score error)."""
    from yolojax_torch.kernels import tree as tk

    t0 = time.perf_counter()
    tk.build()
    log(f"[tree] built {tk.SOURCE.name} in {time.perf_counter() - t0:.2f} s")
    launches, path, path_err = yolo9000_path()
    result, err = tree_phase(card)
    result["path"] = path
    result["head_conv"] = head_conv_times(card)
    result["seconds"] = time.perf_counter() - t0
    log(f"[tree] phase 18 took {result['seconds']:.1f} s")
    return launches, result, max(err, path_err)


def kernel_row(name: str, source: str, replaces: str, launches: int, err: float,
               times: dict) -> dict:
    return {"name": name, "route": "cuda", "source": f"yolojax_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": times["ms"], "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
            "bound_by": times["bound_by"], "library_ms": times.get("library_ms")}


TREE_SOURCE = ("tree_decode.cu", "none: the JAX package has no WordTree head")


def main() -> None:
    args = sys.argv[1:]
    if args[:1] == ["--node-rank"] and len(args) == 2:
        node_rank(args[1])
        return
    if args == ["--bench-launches"]:
        counted_bench()
        return
    if args == ["--calibrate"]:
        calibrate(check_device()[1])
        return
    if args == ["--tree"]:
        card = check_device()[1]
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        launches, result, err = tree_paths(card)
        print(json.dumps({"tree": result}, default=str), flush=True)
        print(json.dumps({"kernels": [kernel_row("tree_decode", *TREE_SOURCE,
                                                 launches["tree_decode"], err,
                                                 result[TIME_BATCHES[0]])]}), flush=True)
        return
    if args[:1] == ["--profile"] and len(args) <= 2:
        path = args[1] if len(args) == 2 else "mobilenet"
        if path not in PROFILE_PATHS:
            raise SystemExit(f"chip_smoke: --profile takes one of {sorted(PROFILE_PATHS)}")
    elif args:
        raise SystemExit(f"chip_smoke: unknown arguments {args}; see the docstring")
    name, card = check_device()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_kernels()
    if args:
        profile(card, path)
        return
    t0 = time.perf_counter()
    host_split(card)
    err = {"postprocess_fused": max(fused_vs_plain(),
                                    fused_vs_plain(EVAL_GEOMETRIES, EVAL_TOPK, seed=1)),
           **dw_vs_plain(), "nms_select": nms_vs_plain(), **layout_vs_plain()}
    fused_one_launch()
    cuda_tests()
    # each model's times right after its path, so Darknet's stay comparable
    # with runs that drive Darknet alone
    dark_model, dark_folded, dark_run, dark_launches = darknet_path()
    epilogue_err = epilogue_vs_plain(dark_model, dark_folded, "darknet")
    dark_t = darknet_times(dark_model, dark_folded, dark_run, card)
    del dark_model, dark_folded, dark_run
    mob_model, mob_folded, mob_run, mob_launches = kernel_path(
        "mobilenet", mobilenet_config, DW_TOKENS, exact=False)
    epilogue_err = max(epilogue_err, epilogue_vs_plain(mob_model, mob_folded, "mobilenet"))
    dw_t = dw_times(card)
    detect_times(mob_model, mob_folded, mob_run, DW_TOKENS, "MobileNet", card)
    del mob_model, mob_folded, mob_run
    s2d_model, s2d_folded, s2d_run, s2d_launches = kernel_path(
        "darknet-s2d", s2d_config, {"pool", "reorg"}, exact=True)
    epilogue_err = max(epilogue_err, epilogue_vs_plain(s2d_model, s2d_folded, "darknet-s2d"))
    fused_routing(s2d_model, s2d_folded, "darknet-s2d", {"pool", "reorg"})
    nms_t = nms_times(s2d_model, s2d_folded, card)
    detect_times(s2d_model, s2d_folded, s2d_run, {"pool", "reorg"}, "Darknet-s2d", card)
    del s2d_model, s2d_folded, s2d_run
    tiny_model, tiny_folded, tiny_run, tiny_launches = kernel_path(
        "tiny", tiny_config, {"pool"}, exact=True)
    epilogue_err = max(epilogue_err, epilogue_vs_plain(tiny_model, tiny_folded, "tiny"))
    fused_routing(tiny_model, tiny_folded, "tiny", {"pool"})
    detect_times(tiny_model, tiny_folded, tiny_run, {"pool"}, "Tiny", card)
    del tiny_model, tiny_folded, tiny_run
    layout_t = layout_times(card)
    epilogue_t, times_err = epilogue_times(card)
    err["bias_leaky_nhwc"] = max(epilogue_err, times_err)
    train_launches, train_result, final = train_phase(card)
    eval_launches, eval_result = eval_phase(card, final)
    deploy_launches, deploy_result = deploy_phase(card, final)
    dist_launches, dist_result = dist_phase(card, final, eval_result)
    gate_launches, gate_result = gate_phase(card)
    prune_launches, prune_result = prune_phase(card)
    bench_launches, bench_result = bench_phase(card)
    nodes_launches, nodes_result = nodes_phase(card)
    tree_launches, tree_result, err["tree_decode"] = tree_paths(card)
    err = {k: max(e, nodes_result["c80"]["max_abs_err"].get(k, 0.0)) for k, e in err.items()}
    log(f"[done] checks and times took {time.perf_counter() - t0:.1f} s after the build")

    # launches: summed over the four main paths' runs (3 batches each) and the
    # later phases' (train, eval, deploy, the data-parallel ranks', the two
    # gates', the bench's); ms, plain_ms, library_ms and bound_ms at batch 8:
    # fused on Darknet's raw
    # head, nms_select on Darknet-s2d's decoded head, dwconv3x3 and dwsep
    # summed over one MobileNet-416 forward's routed layers, maxpool2x2 over
    # one Darknet-416 forward's routed pools (fused, on the convs' raw
    # outputs), reorg_s2d fused with c21's epilogue and the concat,
    # bias_leaky_nhwc on c1's (8, 416, 416, 32) output, tree_decode on phase 18's
    # seeded (8, 17, 17, 28269) head
    paths = (dark_launches, mob_launches, s2d_launches, tiny_launches, train_launches,
             eval_launches, deploy_launches, dist_launches, gate_launches, prune_launches,
             bench_launches, nodes_launches, tree_launches)
    b = TIME_BATCHES[0]
    fused = dark_t[b]
    times = {"postprocess_fused": {"ms": fused["kernel_ms"], "plain_ms": fused["plain_ms"],
                                   "library_ms": None, "bound_ms": fused["bound_ms"],
                                   "bound_by": fused["bound_by"]},
             "dwconv3x3": dw_t[("dwconv3x3", b)], "dwsep": dw_t[("dwsep", b)],
             "nms_select": nms_t[b], "maxpool2x2": layout_t[("maxpool2x2", "Darknet", b)],
             "reorg_s2d": layout_t[("reorg_s2d", b)],
             "bias_leaky_nhwc": epilogue_t[("c1", b)], "tree_decode": tree_result[b]}
    sources = {"postprocess_fused": ("postprocess_fused.cu", "yolojax/kernels/nms.py:247"),
               "dwconv3x3": ("dwconv3x3.cu", "yolojax/kernels/dwconv.py:65"),
               "dwsep": ("dwsep.cu", "yolojax/kernels/dwsep.py:104"),
               "nms_select": ("nms_select.cu", "yolojax/kernels/nms.py:118"),
               "maxpool2x2": ("maxpool2x2.cu", "yolojax/kernels/pool.py:40"),
               "reorg_s2d": ("reorg_s2d.cu", "yolojax/kernels/reorg.py:38"),
               "bias_leaky_nhwc": ("bias_leaky.cu", "yolojax/models/engine.py::_post_conv"),
               "tree_decode": TREE_SOURCE}
    print(json.dumps({"train": train_result}), flush=True)
    print(json.dumps({"eval": eval_result}), flush=True)
    print(json.dumps({"deploy": deploy_result}), flush=True)
    print(json.dumps({"dist": dist_result}), flush=True)
    print(json.dumps({"gate": gate_result}), flush=True)
    print(json.dumps({"prune_gate": prune_result}), flush=True)
    print(json.dumps({"bench": bench_result}), flush=True)
    print(json.dumps({"nodes": nodes_result}), flush=True)
    print(json.dumps({"tree": tree_result}, default=str), flush=True)
    print(json.dumps({"kernels": [
        kernel_row(k, *sources[k], sum(p[k] for p in paths), err[k], times[k])
        for k in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
