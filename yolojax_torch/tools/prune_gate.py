"""The prune → finetune → recover gate through the port — counterpart of
``scripts/prune_gate.py``.

    python -m yolojax_torch.tools.prune_gate [--root DIR] [--fresh] [--images 600]
        [--steps 6000] [--sparsity 0.01] [--ratio 0.4] [--finetune-steps 2000]
        [--finetune-lr 1e-3] [--scratch-control] [--sweep 0.05,0.1]
        [--skip-finetune] [--out SYNTH_GATE_TORCH_PRUNE.json] [--device cuda]

Network slimming's claim is not the mask mechanics but that a model pruned
by BN-γ finetunes back to its accuracy.  The chain, on the Darknet gate's
workspace (``tools/synth_gate.py``; ``build/synth_gate_torch`` by default)
or, with ``--fresh``, on a dense source built here (the synthetic VOC set,
its cache, five k-means anchors, Darknet-19 trained with ``[train]
sparsity`` pinned to 416: ``multi_scale 416..416`` and the canvas derived
from it):

    dense checkpoint        → eval at 416/stretch         map_dense_416
    cli/prune.py --ratio R  → channels.json and the pruned npz
    pruned, frozen          → eval under model/channels   map_pruned_416
    finetune N steps        → python -m yolojax_torch.cli.train -r to step
                              dense + N in a fresh model dir seeded with the
                              pruned npz; milestones at 60 % and 90 % of N,
                              absolute; train/sparsity=0
    finetuned               → eval                        map_finetuned_416

``--scratch-control`` trains the pruned architecture from a random init for
the same N steps and schedule; ``--sweep λ,…`` trains one more dense source
per λ on the same cache and records the share of γ mass its kept channels
hold (``tools/prune.py::gamma_concentration``) and its pruned mAP before
any finetune.  Pass: the finetuned mAP within ``MAX_RECOVERY_DEFICIT`` of
the dense one, frozen at 0.03 by the JAX package's gate, and the finetune
run to its last step.

The artifact, ``SYNTH_GATE_TORCH_PRUNE.json`` at the repo root by default,
carries the JAX package's fields plus a ``device`` block (the card's name
and power limit), each eval's kernel launches (``eval_launches``) and each
stage's wall seconds (``stage_seconds``), and is printed as one JSON line.
The gate runs on the card (``--device cuda``, the default) and raises where
there is none.  Exit code 0 for a pass, 1 for a fail.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time

from .synth_gate import (REPO, _since, _stage, device_block, launches, require_device,
                         train_subprocess, write_overlay)

SIZE = 416                  # the source's pinned train size and every eval's input size
MAX_RECOVERY_DEFICIT = 0.03


def pins(sparsity: float) -> list:
    """The ``-m`` mods that pin a ``--fresh`` source to ``SIZE`` (the canvas
    derived from it: 512 at 416) and set its L1 on BN γ."""
    return ["-m", f"train/multi_scale_min={SIZE}", "-m", f"train/multi_scale_max={SIZE}",
            "-m", "data/canvas=", "-m", f"train/sparsity={sparsity}"]


def gate_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="the prune -> finetune -> recover gate "
                                             "through the port")
    ap.add_argument("--root", default=os.path.join(REPO, "build", "synth_gate_torch"),
                    help="trained darknet/voc gate workspace (tools/synth_gate.py's)")
    ap.add_argument("--ratio", type=float, default=0.4,
                    help="fraction of prunable channels to REMOVE")
    ap.add_argument("--finetune-steps", type=int, default=2000)
    ap.add_argument("--finetune-lr", type=float, default=1e-3,
                    help="finetune base LR (decays at 60%% / 90%% of the budget)")
    ap.add_argument("--sparsity", type=float, default=0.01,
                    help="[train] sparsity (L1 on BN gamma) for the --fresh dense source")
    ap.add_argument("--steps", type=int, default=6000,
                    help="the step budget the source gate was trained with")
    ap.add_argument("--skip-finetune", action="store_true",
                    help="reuse the finetuned checkpoint, just re-run evals")
    ap.add_argument("--fresh", action="store_true",
                    help="build the dense source workspace here: generate synthetic VOC, "
                         "cache, estimate anchors, train darknet pinned to 416 for --steps")
    ap.add_argument("--images", type=int, default=600,
                    help="--fresh: synthetic dataset size")
    ap.add_argument("--scratch-control", action="store_true",
                    help="equal-budget control: train the PRUNED architecture from random "
                         "init for --finetune-steps at the same LR schedule")
    ap.add_argument("--sweep", default="",
                    help="comma-separated extra sparsity values: for each, train another "
                         "dense source on the same cache and record the gamma mass kept and "
                         "the pre-finetune pruned mAP")
    ap.add_argument("--out", default="SYNTH_GATE_TORCH_PRUNE.json",
                    help="artifact, relative to the repo root")
    ap.add_argument("--device", default="cuda", help="torch device (cuda | cpu)")
    return ap


def run_chain(args, extra_cfg: list) -> dict:
    """The chain of ``scripts/prune_gate.py`` on the port's modules; returns
    the artifact.  ``extra_cfg`` (ini files) is stacked after the gate's
    overlay, before the source's pins."""
    from ..cli import make_parser, setup
    from ..cli.common import build, load_weights_auto
    from ..cli.eval import run_eval
    from ..cli.prune import main as prune_main
    from ..config import get_canvas, get_model_dir
    from ..data.cache import load_cache
    from .prune import gamma_concentration

    stage_s, eval_launches = {}, {}

    def timed(name: str, fn, *a, **k):
        t = time.time()
        out = fn(*a, **k)
        stage_s[name] = round(time.time() - t, 1)
        return out

    def train(name: str, steps: int, *extra: str) -> None:
        _stage(f"the {name} train subprocess",
               timed(f"train_{name}", train_subprocess, cfg, steps, args.device, *extra))

    root = args.root
    data_root = os.path.join(root, "VOC2007")
    if args.fresh:
        from ..cli.cache import main as cache_main
        from ..cli.estimate import main as estimate_main
        from ..data.synth import generate_voc

        os.makedirs(root, exist_ok=True)
        data_root = timed("data", generate_voc, root, args.images)
        overlay = write_overlay(root, data_root, args.steps)
        cfg = ["-c", os.path.join(REPO, "config.ini"), overlay, *extra_cfg,
               *pins(args.sparsity)]
        _stage("the cache step", timed("cache", cache_main, cfg))
        _stage("anchor estimation", timed("anchors", estimate_main, cfg + [
            "-k", "5", "-o", os.path.join(root, "anchors.tsv")]))
        train("source", args.steps)
    elif not os.path.isdir(data_root):
        raise SystemExit(f"no gate workspace at {root}: run "
                         "python -m yolojax_torch.tools.synth_gate first")
    else:
        overlay = write_overlay(root, data_root, args.steps)
        cfg = ["-c", os.path.join(REPO, "config.ini"), overlay, *extra_cfg]
    pruned_dir = os.path.join(root, "pruned")
    channels = os.path.join(pruned_dir, "channels.json")
    ch_override = ["-m", f"model/channels={channels}"]

    def config_of(extra):
        return setup(make_parser("prune gate").parse_args(cfg + extra))

    def eval_at_size(name: str, extra, resume=True, fil=None):
        config = config_of(extra)
        config.set("transform", "resize", "yolojax.data.transform.stretch")
        category, _, model = build(config)
        params, state, meta = load_weights_auto(config, model, fil, resume=resume,
                                                device=args.device)
        records = load_cache(config, "test")
        before = launches()
        r = timed(f"eval_{name}", run_eval, config, model, params, state, records, SIZE,
                  config.getint("eval", "batch_size"), category)
        eval_launches[name] = _since(before)
        return round(r["map"], 4), int(meta.get("step", 0) or 0)

    def prune(name: str, extra, out_dir: str) -> None:
        _stage(f"the {name} step", timed(name, prune_main, cfg + extra + [
            "--ratio", str(args.ratio), "-o", out_dir]))

    def load_params(extra):
        config = config_of(extra)
        _, _, model = build(config)
        params, _, _ = load_weights_auto(config, model, None, resume=True)
        return model, params

    t0 = time.time()
    map_dense, dense_step = eval_at_size("dense", [])
    print(f"dense     mAP@0.5 @{SIZE}: {map_dense:.4f} (step {dense_step})", flush=True)

    # prune the same latest checkpoint the dense eval used
    prune("prune", [], pruned_dir)
    pruned_ckpt = os.path.join(pruned_dir, f"{dense_step}.npz")
    map_pruned, _ = eval_at_size("pruned", ch_override, resume=False, fil=pruned_ckpt)
    print(f"pruned    mAP@0.5 @{SIZE}: {map_pruned:.4f} (ratio {args.ratio})", flush=True)

    # finetune in a fresh model dir seeded with the pruned checkpoint: -r
    # restores step = dense_step, so the milestones are absolute
    total = dense_step + args.finetune_steps
    m1 = dense_step + int(args.finetune_steps * 0.6)
    m2 = dense_step + int(args.finetune_steps * 0.9)
    ft_overrides = ch_override + [
        "-m", "model/name=synthgate_darknet_voc_pruned",
        "-m", f"train/learning_rate={args.finetune_lr}",
        "-m", f"train/milestones={m1},{m2}",
        # the L1 pull trains for prunability; the finetune trains for recovery
        "-m", "train/sparsity=0",
    ]
    if not args.skip_finetune:
        ft_dir = get_model_dir(config_of(ft_overrides))
        os.makedirs(ft_dir, exist_ok=True)
        shutil.copy2(pruned_ckpt, os.path.join(ft_dir, f"{dense_step}.npz"))
        train("finetune", total, *ft_overrides, "-r")
    map_finetuned, ft_step = eval_at_size("finetuned", ft_overrides)
    print(f"finetuned mAP@0.5 @{SIZE}: {map_finetuned:.4f} (step {ft_step})", flush=True)

    # equal-budget scratch control: the same pruned architecture, step budget
    # and LR schedule; only the init differs
    scratch_control = None
    if args.scratch_control:
        s1, s2 = int(args.finetune_steps * 0.6), int(args.finetune_steps * 0.9)
        sc_overrides = ch_override + [
            "-m", "model/name=synthgate_darknet_voc_scratch",
            "-m", f"train/learning_rate={args.finetune_lr}",
            "-m", f"train/milestones={s1},{s2}",
            "-m", "train/sparsity=0",
        ]
        if not args.skip_finetune:
            train("scratch", args.finetune_steps, *sc_overrides)
        map_scratch, sc_step = eval_at_size("scratch", sc_overrides)
        print(f"scratch   mAP@0.5 @{SIZE}: {map_scratch:.4f} (step {sc_step}, equal budget)",
              flush=True)
        scratch_control = {
            "map_scratch_416": map_scratch, "steps": args.finetune_steps,
            "lr": args.finetune_lr, "milestones": [s1, s2],
            "architecture": "pruned (same channels.json)",
            "pruned_init_beats_scratch": bool(map_finetuned > map_scratch),
        }

    # the sparsity sweep: per λ a fresh dense source on the same cache and
    # anchors, the γ mass its kept channels hold and its pruned mAP
    main_model, main_params = load_params([])
    sweep = [{
        "sparsity": args.sparsity,
        "gamma_mass_kept": round(gamma_concentration(main_model, main_params, args.ratio), 4),
        "map_dense_416": map_dense,
        "map_pruned_416_prefinetune": map_pruned,
        "source": "main",
    }]
    for lam_s in [s for s in args.sweep.split(",") if s.strip()]:
        lam = float(lam_s)
        tag = lam_s.strip().replace(".", "p")
        sw_overrides = ["-m", f"model/name=synthgate_darknet_voc_sw{tag}",
                        "-m", f"train/sparsity={lam}"]
        if not args.skip_finetune:
            train(f"sw{tag}", args.steps, *sw_overrides)
        sw_dense, sw_step = eval_at_size(f"sw{tag}_dense", sw_overrides)
        sw_model, sw_params = load_params(sw_overrides)
        conc = gamma_concentration(sw_model, sw_params, args.ratio)
        sw_pruned_dir = os.path.join(root, f"pruned_sw{tag}")
        prune(f"prune_sw{tag}", sw_overrides, sw_pruned_dir)
        sw_ch = ["-m", f"model/channels={os.path.join(sw_pruned_dir, 'channels.json')}"]
        sw_map_pruned, _ = eval_at_size(f"sw{tag}_pruned", sw_overrides + sw_ch, resume=False,
                                        fil=os.path.join(sw_pruned_dir, f"{sw_step}.npz"))
        print(f"sweep λ={lam}: dense {sw_dense:.4f}, γ-mass kept {conc:.4f}, pruned "
              f"(pre-finetune) {sw_map_pruned:.4f}", flush=True)
        sweep.append({"sparsity": lam, "gamma_mass_kept": round(conc, 4),
                      "map_dense_416": sw_dense,
                      "map_pruned_416_prefinetune": sw_map_pruned,
                      "source": f"sw{tag} ({args.steps} steps, same cache)"})

    ok = (map_finetuned >= map_dense - MAX_RECOVERY_DEFICIT) and ft_step >= total
    with open(channels) as f:
        n_kept = sum(json.load(f).values())
    config = config_of([])
    return {
        "source": {"workspace": root, "model": "darknet", "step": dense_step,
                   "recipe": (f"production config pinned to {SIZE} (multi_scale "
                              f"{SIZE}..{SIZE}, derived canvas {get_canvas(config)}), "
                              f"{args.steps}-step dense source trained with [train] "
                              f"sparsity={args.sparsity} (L1 on BN gamma, network slimming) "
                              "— sound for the RELATIVE recovery criterion; multi-scale "
                              "robustness is SYNTH_GATE_TORCH.json's evidence"
                              if args.fresh else
                              "tools/synth_gate.py production multi-scale recipe")},
        "ratio": args.ratio,
        "ratio_semantics": "fraction of prunable channels REMOVED "
                           "(r5 fix; the r4 run's 0.4 removed 60%)",
        "channels_kept": n_kept,
        "map_dense_416": map_dense,
        "map_pruned_416": map_pruned,
        "map_finetuned_416": map_finetuned,
        "recovery_delta": round(map_finetuned - map_dense, 4),
        "sparsity": args.sparsity if args.fresh else 0.0,
        "finetune": {"steps": args.finetune_steps, "lr": args.finetune_lr,
                     "milestones": [m1, m2], "wall_s": round(time.time() - t0, 1)},
        "scratch_control": scratch_control,
        "sparsity_sweep": sweep,
        "criteria": {"max_recovery_deficit": MAX_RECOVERY_DEFICIT},
        "pass": bool(ok),
        "device": device_block(args.device, config.get("model", "dtype", fallback="bfloat16")),
        "eval_launches": eval_launches,
        "stage_seconds": stage_s,
    }


def main(argv=None, extra_cfg: list | None = None) -> int:
    """The gate's CLI; ``extra_cfg`` is stacked after the gate's overlay."""
    ap = gate_parser()
    args = ap.parse_args(argv)
    if args.sparsity > 0 and not args.fresh:
        # --sparsity sets the dense source's training, which only --fresh runs;
        # an existing workspace keeps however its source was trained
        ap.error("--sparsity only takes effect with --fresh (it sets "
                 "[train] sparsity for the dense source training); reusing "
                 "an existing workspace keeps however that source was "
                 "trained — pass --sparsity 0 to acknowledge, or --fresh")
    require_device(args.device)
    out = run_chain(args, list(extra_cfg or ()))
    with open(os.path.join(REPO, args.out), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0 if out["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
