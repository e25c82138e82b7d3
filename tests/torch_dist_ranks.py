"""Rank bodies of the port's distributed tests.

``parallel/collectives.py::run_ranks`` spawns each rank as a fresh process
that imports ``fn`` by its module path; this module imports torch, numpy and
``yolojax_torch`` only, so a rank never loads JAX.  The same bodies run in
the test process with ``group=None``, on the global batch, as the
one-process reference.
"""

import configparser
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from yolojax_torch.data.transform import TrainAugment
from yolojax_torch.models.darknet import Darknet
from yolojax_torch.ops.loss import LossConfig
from yolojax_torch.parallel.mesh import batch_slice, loss_weights_from_config, make_train_step
from yolojax_torch.utils.train import build_optimizer

ANCHORS = np.asarray([[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11], [16.62, 10.52]],
                     np.float32)
COMPONENTS = ("coord", "object", "noobject", "cls", "prior", "total", "grad_norm")
STEPS = 3
SIZE = 64        # the step's input size
CANVAS = 96      # the augmented runs' canvas
BOXES = 3


def train_config() -> configparser.ConfigParser:
    """``tests/test_torch_train_step.py``'s sgd: clip, BN-γ sparsity, weight
    decay, momentum and a milestone at step 2."""
    config = configparser.ConfigParser()
    config.read_dict({"train": {
        "optimizer": "yolojax.utils.train.sgd", "learning_rate": "1e-3", "momentum": "0.9",
        "weight_decay": "5e-4", "milestones": "2", "gamma": "0.1", "clip": "5.0",
        "sparsity": "0.01"}, "loss": {}})
    return config


def global_batches(b: int, augment: bool, steps: int = STEPS, seed: int = 7) -> list[dict]:
    """``steps`` seeded global batches of ``b`` images as numpy: images in
    [0, 1] at SIZE², or with ``augment`` uint8 canvases of 64×80 images and
    their boxes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        center = rng.uniform(0.3, 0.7, (b, BOXES, 2)).astype(np.float32)
        half = rng.uniform(0.05, 0.25, (b, BOXES, 2)).astype(np.float32)
        batch = {"yx_min": np.clip(center - half, 0, 1), "yx_max": np.clip(center + half, 0, 1),
                 "cls": rng.integers(0, 20, (b, BOXES)).astype(np.int32),
                 "valid": np.ones((b, BOXES), bool)}
        if augment:
            batch["canvas"] = rng.integers(0, 256, (b, CANVAS, CANVAS, 3), dtype=np.uint8)
            batch["hw"] = np.tile(np.asarray([[64, 80]], np.float32), (b, 1))
        else:
            batch["images"] = rng.uniform(0, 1, (b, SIZE, SIZE, 3)).astype(np.float32)
        out.append(batch)
    return out


def numpy_tree(tree: dict) -> dict:
    return {k: {n: v.detach().cpu().numpy() for n, v in lp.items()} for k, lp in tree.items()}


def train_run(group, dtype: str, b: int, augment: bool, params=None, state=None,
              device: str = "cpu", steps: int = STEPS) -> dict:
    """``steps`` steps of full-width Darknet-19 on ``device`` on the global
    batches of ``b`` images, this rank's share of each (all of it with no
    group), from ``params`` / ``state`` (numpy trees) or the seed-0 init.
    Returns the metrics of each step, the BN state after the first, and the
    first and final params, the final state and momentum trace, as numpy."""
    dtype = getattr(torch, dtype)
    model = Darknet(anchors=ANCHORS, num_classes=20, dtype=dtype)
    if params is None:
        params, state = model.init(torch.Generator().manual_seed(0))
    else:
        params, state = ({k: {n: torch.from_numpy(v) for n, v in lp.items()}
                          for k, lp in tree.items()} for tree in (params, state))
    params = {k: {n: v.to(device, dtype) for n, v in lp.items()} for k, lp in params.items()}
    state = {k: {n: v.to(device, dtype) for n, v in lp.items()} for k, lp in state.items()}
    config = train_config()
    optimizer = build_optimizer(config)
    opt_state = optimizer.init(params)
    aug = TrainAugment(dtype=dtype) if augment else None
    step = make_train_step(model, optimizer, loss_weights_from_config(config), LossConfig(),
                           augment=aug, group=group)
    out = {"metrics": [], "start": numpy_tree(params)}
    for i, batch in enumerate(global_batches(b, augment, steps)):
        mine = {k: torch.from_numpy(v).to(device) for k, v in batch_slice(batch, group).items()}
        if augment:
            draws = batch_slice(aug.draw(torch.Generator().manual_seed(100 + i), b), group)
            params, state, opt_state, m = step(params, state, opt_state, mine, 0, draws, SIZE)
        else:
            params, state, opt_state, m = step(params, state, opt_state, mine, 0)
        out["metrics"].append({k: m[k].item() for k in COMPONENTS})
        if i == 0:
            out["state_1"] = numpy_tree(state)
    out.update(params=numpy_tree(params), state=numpy_tree(state),
               trace=numpy_tree(opt_state["trace"]), count=opt_state["count"])
    return out


def rel_err(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want‖ over every leaf of two ``{layer: {name: array}}``."""
    assert got.keys() == want.keys()
    diff = sum(np.sum((got[k][n] - want[k][n]) ** 2) for k in want for n in want[k])
    norm = sum(np.sum(want[k][n] ** 2) for k in want for n in want[k])
    return float(np.sqrt(diff / norm))


def change(tree: dict, start: dict) -> dict:
    return {k: {n: v - start[k][n] for n, v in lp.items()} for k, lp in tree.items()}


def digest(run: dict) -> dict:
    """A hash of every leaf's bytes of a run's params, state and trace."""
    return {f"{key} {k}.{n}": hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for key in ("params", "state", "trace") for k, lp in run[key].items()
            for n, v in lp.items()}


def summary(run: dict) -> dict:
    return {"metrics": run["metrics"], "count": run["count"], "digest": digest(run)}


def against_one_process(group, run: dict, *args, **kwargs) -> dict:
    """``run`` (this rank's ``train_run(group, *args, **kwargs)``) in short;
    on rank 0 also how far it lies from ``train_run(None, *args,
    **kwargs)``, one process on the global batch, run there: the
    full-width trees are too large to send from every rank."""
    out = summary(run)
    if dist.get_rank(group) == 0:
        one = train_run(None, *args, **kwargs)
        out["one"] = {"metrics": one["metrics"], "count": one["count"],
                      "change": rel_err(change(run["params"], one["start"]),
                                        change(one["params"], one["start"])),
                      **{key: rel_err(run[key], one[key]) for key in ("params", "state", "trace")}}
    return out


def cuda_step(group, b: int) -> dict:
    """One float32 step with the augmentation on ``cuda:0``, TF32 off,
    deterministic cuDNN, against one process on the card
    (:func:`against_one_process`)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = ("float32", b, True)
    return against_one_process(group, train_run(group, *args, device="cuda", steps=1), *args,
                               device="cuda", steps=1)


def both_runs(group, b: int, params, state) -> dict:
    """A float64 run with the augmentation from the seed-0 init, against one
    process (:func:`against_one_process`), and a float32 run without it from
    ``params`` / ``state``, whose trees rank 0 also returns."""
    f64 = train_run(group, "float64", b, True)
    f32 = train_run(group, "float32", b, False, params, state)
    out = {"f64": against_one_process(group, f64, "float64", b, True), "f32": summary(f32)}
    if dist.get_rank(group) == 0:
        out["f32"].update({key: {k: {n: torch.from_numpy(v) for n, v in lp.items()}
                                 for k, lp in f32[key].items()}   # tensors: sent fast
                           for key in ("params", "state", "trace", "state_1")})
    return out


def eval_run(group, cfg: list, batches: tuple, size: int) -> dict:
    """``cli/eval.py::run_eval`` on the workspace of ``cfg`` (its model dir's
    latest checkpoint, the test cache) at each global batch of ``batches``:
    {batch: {map, ap, detections}} with every detection in recording order."""
    from yolojax_torch.cli.common import build, load_weights_auto
    from yolojax_torch.cli.eval import run_eval
    from yolojax_torch.config import load_config
    from yolojax_torch.data.cache import load_cache

    config = load_config(cfg[1:])
    category, _, model = build(config)
    params, state, _ = load_weights_auto(config, model, resume=True)
    out = {}
    for batch in batches:
        result = run_eval(config, model, params, state, load_cache(config, "test"), size, batch,
                          category, group=group)
        out[batch] = {"map": result["map"], "ap": result["ap"],
                      "detections": [(c, img, conf, dmin.tolist(), dmax.tolist())
                                     for c, dets in sorted(result["recorder"].dets.items())
                                     for img, conf, dmin, dmax in dets]}
    return out


def train_cli(group, argv: list) -> dict:
    """``cli/train.py``'s ``Train`` built from ``argv`` (the group is the
    default one ``Train`` finds) and run to ``--steps``; returns its step,
    seen, images a rank, steps an epoch, hashes of its params and state, and
    whether it wrote a summary."""
    from yolojax_torch.cli import setup
    from yolojax_torch.cli.train import Train, train_parser

    args = train_parser().parse_args(argv)
    train = Train(args, setup(args))
    assert (train.group is None) == (group is None)
    train(max_steps=args.steps)
    return {"step": train.step, "seen": train.seen, "lead": train.summary is not None,
            "batch": train.batch_size, "steps_per_epoch": train.steps_per_epoch,
            "digest": digest({"params": numpy_tree(train.params), "state": numpy_tree(train.state),
                              "trace": numpy_tree(train.opt_state["trace"])})}


def reduce_on_card(group) -> tuple:
    """``all_reduce_sum`` of ``(rank + 1) · [1, 2, 3]`` on ``cuda:0``, and the
    gradient of ``(rank + 1) · Σ sum`` back to the input."""
    from yolojax_torch.parallel.collectives import all_reduce_sum

    scale = dist.get_rank(group) + 1.0
    x = torch.tensor([1.0, 2.0, 3.0], device="cuda", requires_grad=True)
    y = all_reduce_sum(x * scale, group)
    (y.sum() * scale).backward()
    assert y.is_cuda and x.grad.is_cuda
    return y.detach().cpu().numpy(), (x.grad / scale).cpu().numpy()
