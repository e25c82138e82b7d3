"""The synthetic accuracy gate through the port — counterpart of
``scripts/synth_gate.py``.

    python -m yolojax_torch.tools.synth_gate [--model darknet|tiny|mobilenet]
        [--format voc|coco] [--classes 8|80] [--images 600] [--steps 6000]
        [--root DIR] [--out NAME.json] [--skip-train] [--resume] [--device cuda]
    python -m yolojax_torch.tools.synth_gate --readjudicate SYNTH_GATE_TORCH.json

No real VOC or COCO ships with the repository, so the gate generates a
synthetic set (``data/synth.py``: 8 shape classes, or 80 shape × hue
classes, 2–6 objects an image, occlusion up to IoU 0.45), caches it
(``cli/cache.py``), re-estimates five anchors with k-means (``cli/estimate.py``;
Tiny keeps its shipped tiny-voc anchors), trains from scratch with the
production recipe (``config.ini`` plus the backbone's ``config/<model>.ini``
and the gate's overlay: multi-scale 320–608, warmup, milestones at 75 % and
92 % of the steps, bf16, batch 16, the device-resident dataset) as a
``python -m yolojax_torch.cli.train`` subprocess, so that its RSS watchdog
owns argv, and evaluates the latest checkpoint: mAP@0.5 over {320, 416,
544, 608} × {stretch, letterbox} and COCO AP@[.5:.95] at 416/stretch.  The
results are held to the frozen criteria table of the JAX package's gate,
copied here (``CRITERIA``, ``criteria_for``, ``adjudicate``): a failure
anywhere in the chain (cache, augmentation, loss, optimizer, decode, NMS,
the resize's inversion, AP) pulls one of the numbers down.

After the grid, 416/stretch is evaluated once more with the backbone's
forward kernels routed (``KERNEL_EVALS``), so that they run on trained
weights too; those evaluations and each eval's kernel launches go into the
artifact and stay out of the adjudication.

The artifact, ``SYNTH_GATE_TORCH[_MODEL][_FMT][NN].json`` at the repo root
by default, carries the JAX package's fields plus a ``device`` block (the
card's name and power limit, the torch and CUDA versions, the dtype) and
is printed as one JSON line.  ``--skip-train`` and ``--readjudicate``
append to an existing artifact, never replace its train block, as in the
JAX package.  The gate runs on the card (``--device cuda``, the default)
and raises where there is none; the tests pass ``--device cpu``.  The
chain itself is :func:`run_gate`, which takes the config list, so a caller
can stack one more overlay after the gate's.  Exit code 0 for a pass, 1
for a fail, 2 where a kernel evaluation disagrees with the default one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..data.synth import CLASSES, Raster, generate_coco, generate_voc, make_classes, painter

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODELS = {"darknet": "yolojax.models.darknet.Darknet",
          "mobilenet": "yolojax.models.mobilenet.MobileNet",
          "tiny": "yolojax.models.darknet.Tiny"}

# The frozen criteria, the two per-workload factors and their history are the
# JAX package's gate's (scripts/synth_gate.py, where each number's derivation
# is written out); tests/test_torch_synth_gate.py holds this copy equal.
CRITERIA = {
    "min_map_416": 0.88,
    "min_map_544_608": 0.90,
    "min_map_320": 0.80,
    "max_lb_delta": 0.06,
    "max_small_size_drop": 0.125,
    "min_coco_ap_416": 0.50,
}
TINY_MAP_FACTOR = 0.74        # tiny-yolo-voc 57.1 against YOLOv2's 76.8 mAP @416
COCO80_MAP_FACTOR = 0.57      # YOLOv2's COCO AP50 44.0 against its VOC 76.8
SMALL_SIZE_ERR_RATIO = 2.125  # (1 - 0.90·0.875) / (1 - 0.90): the r4 bound's anchor
ACCURACY_FLOORS = ("min_map_416", "min_map_544_608", "min_map_320",
                   "min_coco_ap_416")
SIZES = (320, 416, 544, 608)
MODES = ("stretch", "letterbox")

CRITERIA_HISTORY = {
    "r1": {"min_map_416": 0.90, "max_spread": 0.06},
    "r2": {"min_map_416": 0.88, "max_small_size_drop": 0.125},
    "r3": {"min_map_416": 0.88, "min_map_320": 0.80,
           "max_small_size_drop": 0.125},
    "r4": {"min_map_416": 0.88, "min_map_544_608": 0.90,
           "min_map_320": 0.80, "min_coco_ap_416": 0.50,
           "max_lb_delta": 0.06, "max_small_size_drop": 0.125,
           "tiny_accuracy_floor_factor": TINY_MAP_FACTOR},
    "r5": {"coco80_accuracy_floor_factor": COCO80_MAP_FACTOR},
    "r5b": {"max_small_size_err_ratio": SMALL_SIZE_ERR_RATIO,
            "binding_form": "small_drop <= 0.125 OR err_ratio <= 2.125",
            "anchor": "frozen r4 boundary: (1-0.90*0.875)/(1-0.90)",
            "changes_prior_outcomes": False},
}

# 416/stretch once more with the backbone's forward kernels routed: the
# `[model] pallas` tokens and how far its mAP may lie from the default eval's
# (dwsep's bf16 output is not bit-identical to cuDNN's; the pool is, and
# Darknet's `nms` swaps the fused kernel for nms_select on the decoded boxes)
KERNEL_EVALS = {"mobilenet": ("nms fusedpost dwsep dwconv", 1e-3),
                "tiny": ("nms fusedpost pool", 0.0),
                "darknet": ("nms", 0.0)}


def criteria_for(model: str, num_classes: int = len(CLASSES)) -> dict:
    crit = dict(CRITERIA)
    crit["max_small_size_err_ratio"] = SMALL_SIZE_ERR_RATIO
    factor = 1.0
    if model == "tiny":
        factor *= TINY_MAP_FACTOR
    if num_classes >= 80:
        factor *= COCO80_MAP_FACTOR
    if factor != 1.0:
        for k in ACCURACY_FLOORS:
            crit[k] = round(crit[k] * factor, 2)
    return crit


def adjudicate(results: dict, coco_ap: dict, crit: dict) -> tuple[bool, dict]:
    """Apply a frozen criteria table to a measured eval grid.

    ``results`` is the {mode_size: mAP} grid a gate run records, ``coco_ap``
    its 416/stretch COCO block.  Returns (pass, derived-geometry-metrics)."""
    stretch = [results[f"stretch_{s}"] for s in SIZES]
    best = max(stretch)
    spread = best - min(stretch)
    lb_delta = max(abs(results[f"letterbox_{s}"] - results[f"stretch_{s}"]) for s in SIZES)
    small_drop = (best - results["stretch_320"]) / max(best, 1e-9)
    err_ratio = (1.0 - results["stretch_320"]) / max(1.0 - best, 1e-9)
    eps = 1e-9  # inclusive boundaries must survive binary-fp rounding
    small_ok = (small_drop <= crit["max_small_size_drop"] + eps
                or err_ratio <= crit["max_small_size_err_ratio"] + eps)
    ok = (results["stretch_416"] >= crit["min_map_416"] - eps
          and results["stretch_544"] >= crit["min_map_544_608"] - eps
          and results["stretch_608"] >= crit["min_map_544_608"] - eps
          and results["stretch_320"] >= crit["min_map_320"] - eps
          and coco_ap["ap"] >= crit["min_coco_ap_416"] - eps
          and lb_delta <= crit["max_lb_delta"] + eps
          and small_ok)
    derived = {"stretch_spread_across_sizes": round(spread, 4),
               "max_letterbox_vs_stretch_delta": round(lb_delta, 4),
               "small_size_relative_drop": round(small_drop, 4),
               "small_size_err_ratio": round(err_ratio, 4)}
    return bool(ok), derived


def write_overlay(root: str, data_root: str, steps: int,
                  fmt: str = "voc", model: str = "darknet",
                  classes: list[str] | None = None) -> str:
    """The gate's config overlay, the JAX package's text: its ``yolojax.``
    paths resolve to the port through ``config.parse_attr``."""
    classes = classes or CLASSES
    category = os.path.join(root, f"category{len(classes)}")
    with open(category, "w") as f:
        f.write("\n".join(classes))
    if fmt == "coco":
        cache_lines = f"datasets = yolojax.data.coco\ncoco_root = {data_root}"
        eval_phase = "phase = val\n"
    else:
        cache_lines = f"datasets = yolojax.data.voc\nvoc_roots = {data_root}"
        eval_phase = ""
    m1, m2 = int(steps * 0.75), int(steps * 0.92)
    # Tiny trains through its own shipped anchor set (config/tiny.ini)
    anchor_line = "" if model == "tiny" else f"anchors = {root}/anchors.tsv\n"
    # the 80 synthetic classes are hue-defined 36° apart, so the production
    # ±36° hue jitter would be label noise for this dataset: capped at ±14.4°
    transform_lines = ("[transform]\nhue = 0.04\n"
                       if len(classes) >= 80 else "")
    overlay = os.path.join(root, "gate.ini")
    with open(overlay, "w") as f:
        f.write(f"""[config]
root = {root}/artifacts
[cache]
{cache_lines}
category = {category}
[model]
name = synthgate_{model}_{fmt}
dnn = {MODELS[model]}
{anchor_line}[data]
batch_size = 16
max_boxes = 10
canvas = 672
sizes = 416,416
workers = 3
decoded_cache = 1
device_dataset = 1
[train]
learning_rate = 1e-3
clip = 5.0
milestones = {m1},{m2}
multi_scale_min = 320
multi_scale_max = 608
multi_scale_interval = 10
seed = 0
{transform_lines}[eval]
{eval_phase}batch_size = 20
[summary]
scalar = 100
histogram = 1000000
image = 1000000
[save]
interval = 240
keep = 2
""")
    return overlay


def artifact_name(model: str, fmt: str, classes: int) -> str:
    tag = ""
    if model != "darknet":
        tag += f"_{model.upper()}"
    if fmt != "voc":
        tag += f"_{fmt.upper()}"
    if classes != len(CLASSES):
        tag += f"{classes}"
    return f"SYNTH_GATE_TORCH{tag}.json"


def recipe(model: str, classes: int) -> str:
    return ("production config.ini"
            + (f" + config/{model}.ini" if model != "darknet" else "")
            + " (multi-scale 320..608, warmup, bf16; optimizer per "
              "overlay — darknet/tiny sgd+momentum+wd, mobilenet adam)"
            + (" + hue jitter capped 0.04: the 80 synthetic classes "
               "are hue-defined 36° apart, so the production ±36° "
               "jitter is label noise for this dataset"
               if classes >= 80 else ""))


def device_block(device: str, dtype: str) -> dict:
    """The card's name and power limit as ``nvidia-smi`` gives them (None
    where there is no card), the torch and CUDA versions, the dtype."""
    import torch

    smi = None
    if device.startswith("cuda"):
        try:
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            smi = None
    return {"device": device, "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else None,
            "torch": torch.__version__, "cuda": torch.version.cuda, "dtype": dtype}


def launches() -> dict:
    """The kernel wrappers' launch counters."""
    from ..kernels.dwconv import dwconv3x3
    from ..kernels.dwsep import dwsep
    from ..kernels.nms import nms_select
    from ..kernels.pool import maxpool2x2
    from ..kernels.postprocess_fused import postprocess_fused
    from ..kernels.reorg import reorg_s2d

    fns = {"postprocess_fused": postprocess_fused, "dwconv3x3": dwconv3x3, "dwsep": dwsep,
           "nms_select": nms_select, "maxpool2x2": maxpool2x2, "reorg_s2d": reorg_s2d}
    return {k: fn.launches for k, fn in fns.items()}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in launches().items() if v != before[k]}


def _stage(what: str, rc: int) -> None:
    # explicit exit-code checks, not assert: a failed stage aborts under -O too
    if rc != 0:
        raise SystemExit(f"gate: {what} failed (exit code {rc})")


def require_device(device: str) -> None:
    """Raise where the gate is asked for the card and torch sees none."""
    import torch

    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("the gate runs on the card, but torch sees no CUDA device; "
                           "pass --device cpu to run it on the CPU")


def train_subprocess(cfg: list, steps: int, device: str, *extra: str) -> int:
    """``python -m yolojax_torch.cli.train`` on ``cfg`` to ``steps`` in a child
    process (its RSS watchdog owns argv), with the repo on its path; returns
    its exit code."""
    argv = [sys.executable, "-m", "yolojax_torch.cli.train", *cfg, *extra,
            "--steps", str(steps), "--device", device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return subprocess.run(argv, cwd=REPO, env=env).returncode


def run_gate(cfg: list, *, root: str, model: str, fmt: str, classes: int, steps: int,
             skip_train: bool = False, resume: bool = False, device: str = "cuda") -> dict:
    """The chain on the workspace of ``cfg`` (``["-c", config.ini, …]``, the
    gate's overlay last but for a caller's own): cache, anchors, the train
    subprocess, the eval grid, COCO AP, the kernel evaluations and the
    adjudication.  Returns the artifact's fields but ``dataset``."""
    from ..cli import make_parser, setup
    from ..cli.cache import main as cache_main
    from ..cli.common import build, load_weights_auto
    from ..cli.estimate import main as estimate_main
    from ..cli.eval import run_eval
    from ..data.cache import load_cache
    from ..eval_ap import evaluate_coco

    require_device(device)
    t0 = time.time()
    _stage("the cache step", cache_main(cfg))
    # anchors from the data itself; Tiny trains through its shipped tiny-voc.tsv
    if model != "tiny":
        _stage("anchor estimation",
               estimate_main(cfg + ["-k", "5", "-o", os.path.join(root, "anchors.tsv")]))
    if not skip_train:
        _stage("the train subprocess",
               train_subprocess(cfg, steps, device, *(["-r"] if resume else [])))
    train_s = time.time() - t0

    config = setup(make_parser("gate eval").parse_args(cfg))
    category, _, net = build(config)
    params, state, meta = load_weights_auto(config, net, None, resume=True, device=device)
    records = load_cache(config, "val" if fmt == "coco" else "test")
    batch = config.getint("eval", "batch_size")
    results, grid_launches, rec_416, map_416 = {}, {}, None, None
    for mode in MODES:
        config.set("transform", "resize", f"yolojax.data.transform.{mode}")
        for size in SIZES:
            before = launches()
            r = run_eval(config, net, params, state, records, size, batch, category)
            grid_launches[f"{mode}_{size}"] = _since(before)
            results[f"{mode}_{size}"] = round(r["map"], 4)
            if mode == "stretch" and size == 416:
                rec_416, map_416 = r["recorder"], r["map"]
            print(f"mAP@0.5 {mode:10s} @{size}: {r['map']:.4f}  ({r['rate']:.0f} img/s)",
                  flush=True)

    # COCO AP@[.5:.95] on the same 416/stretch detections
    coco = evaluate_coco(rec_416)
    coco_ap = {"ap": round(coco["map"], 4), "ap50": round(coco["map_50"], 4),
               "ap75": round(coco["map_75"], 4)}
    print(f"COCO AP@[.5:.95] stretch @416: {coco_ap['ap']:.4f}  "
          f"(AP50 {coco_ap['ap50']:.4f}, AP75 {coco_ap['ap75']:.4f})", flush=True)

    tokens, bound = KERNEL_EVALS[model]
    config.set("transform", "resize", "yolojax.data.transform.stretch")
    config.set("model", "pallas", tokens)
    _, _, routed = build(config)
    before = launches()
    r = run_eval(config, routed, params, state, records, 416, batch, category)
    gap = abs(r["map"] - map_416)
    kernel_evals = {"stretch_416": {
        "pallas": tokens, "map": r["map"], "default_map": map_416,
        "gap": gap, "bound": bound, "agrees": bool(gap <= bound), "launches": _since(before)}}
    print(f"mAP@0.5 stretch    @416 with pallas = {tokens}: {r['map']:.6f} (gap {gap:.3g}, "
          f"bound {bound})", flush=True)

    crit = criteria_for(model, classes)
    ok, derived = adjudicate(results, coco_ap, crit)
    return {
        "train": {"model": model, "steps": steps, "num_classes": classes,
                  "recipe": recipe(model, classes),
                  # --skip-train measures no training: no train wall time then
                  "wall_s": None if skip_train else round(train_s, 1),
                  "step": int(meta.get("step", 0) or 0)},
        "map": results,
        "coco_ap_416_stretch": coco_ap,
        **derived,
        "criteria": crit,
        "criteria_history": CRITERIA_HISTORY,
        "pass": bool(ok),
        "device": device_block(device, config.get("model", "dtype", fallback="bfloat16")),
        "eval_launches": grid_launches,
        "kernel_evals": kernel_evals,
    }


def readjudicate(path: str) -> int:
    """Criteria-only re-adjudication of an artifact: pass recomputed from its
    recorded numbers under the current table, a dated ``reevals`` entry
    appended."""
    with open(path) as f:
        art = json.load(f)
    model = art["train"]["model"]
    classes = int(art["train"].get("num_classes", len(CLASSES)))
    crit = criteria_for(model, classes)
    ok, derived = adjudicate(art["map"], art["coco_ap_416_stretch"], crit)
    entry = {"date": time.strftime("%Y-%m-%d"), "kind": "criteria-only",
             "criteria": crit, **derived, "prior_pass": art["pass"], "pass": ok}
    art["reevals"] = art.get("reevals", []) + [entry]
    art.update(derived)
    art["criteria"] = crit
    art["criteria_history"] = CRITERIA_HISTORY
    art["pass"] = ok
    with open(path, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(entry))
    return 0 if ok else 1


def gate_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the synthetic accuracy gate through the port")
    ap.add_argument("--root", default=os.path.join(REPO, "build", "synth_gate_torch"),
                    help="workspace: the generated data, caches, checkpoints")
    ap.add_argument("--images", type=int, default=600)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--format", choices=("voc", "coco"), default="voc",
                    help="annotation format / parser path to exercise")
    ap.add_argument("--model", choices=sorted(MODELS), default="darknet")
    ap.add_argument("--classes", type=int, default=len(CLASSES),
                    help="synthetic category count (80 requires --format coco)")
    ap.add_argument("--out", default=None,
                    help="artifact, relative to the repo root "
                         "(default SYNTH_GATE_TORCH[_MODEL][_FMT][NN].json)")
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse the latest checkpoint, just re-run the evals")
    ap.add_argument("--resume", action="store_true",
                    help="pass -r to the train CLI (continue an interrupted gate)")
    ap.add_argument("--readjudicate", metavar="ARTIFACT",
                    help="criteria-only re-adjudication of ARTIFACT: no training, no "
                         "eval; appends a dated reevals entry")
    ap.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    return ap


def prepare(args) -> tuple[list, dict]:
    """Generate the data and write the overlay; returns the config list
    (config.ini, the backbone's ini, the overlay) and the dataset block."""
    os.makedirs(args.root, exist_ok=True)
    class_names, _ = make_classes(args.classes)
    if args.format == "coco":
        data_root = generate_coco(args.root, args.images, num_classes=args.classes,
                                  crowd_frac=0.03)
    else:
        data_root = generate_voc(args.root, args.images)
    overlay = write_overlay(args.root, data_root, args.steps, fmt=args.format,
                            model=args.model, classes=class_names)
    cfg = ["-c", os.path.join(REPO, "config.ini")]
    # the backbone's shipped overlay (its own optimizer recipe) under the gate's
    model_ini = os.path.join(REPO, "config", f"{args.model}.ini")
    if args.model != "darknet" and os.path.exists(model_ini):
        cfg.append(model_ini)
    cfg.append(overlay)
    codec = "ppm (numpy raster, no cv2)" if isinstance(painter(), Raster) else "jpeg (cv2)"
    dataset = {"images": args.images, "classes": args.classes, "format": args.format,
               "occlusion_iou_cap": 0.45, "objects_per_image": "2-6", "codec": codec}
    return cfg, dataset


def finish(out: dict, out_path: str, skip_train: bool) -> dict:
    """Write the artifact; a ``--skip-train`` run appends to an existing one
    and keeps its train block."""
    if skip_train and os.path.exists(out_path):
        with open(out_path) as f:
            prior = json.load(f)
        if "train" in prior:
            out["train"] = prior["train"]
        out["reevals"] = prior.get("reevals", []) + [{
            "date": time.strftime("%Y-%m-%d"), "criteria": out["criteria"], "map": out["map"],
            "coco_ap_416_stretch": out["coco_ap_416_stretch"], "pass": out["pass"]}]
    with open(out_path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, extra_cfg: list | None = None) -> int:
    """The gate's CLI; ``extra_cfg`` is stacked after the gate's overlay."""
    ap = gate_parser()
    args = ap.parse_args(argv)
    if args.readjudicate:
        return readjudicate(os.path.join(REPO, args.readjudicate))
    if args.classes != len(CLASSES) and args.format != "coco":
        ap.error("--classes requires --format coco (the VOC generator is "
                 "pinned to the 8 canonical shapes)")
    out_name = args.out or artifact_name(args.model, args.format, args.classes)
    cfg, dataset = prepare(args)
    result = run_gate(cfg + list(extra_cfg or ()), root=args.root, model=args.model,
                      fmt=args.format, classes=args.classes, steps=args.steps,
                      skip_train=args.skip_train, resume=args.resume, device=args.device)
    out = finish({"dataset": dataset, **result}, os.path.join(REPO, out_name), args.skip_train)
    if not all(e["agrees"] for e in out["kernel_evals"].values()):
        return 2
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
