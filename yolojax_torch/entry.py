"""Entry point of the port's flagship path — counterpart of
``__graft_entry__.py::entry``.

``entry()`` returns ``(fn, (folded, images))``: fused inference (forward →
decode → per-class NMS) on Darknet-19 YOLOv2 at 416×416 in bf16, with VOC's
20 classes and anchors, weights drawn from ``torch.Generator().manual_seed(0)``
and BN folded; ``images`` is a zero batch of 8.  Everything lives on
``device`` (the card unless the caller names another).

``dryrun_multichip(n)`` — counterpart of ``__graft_entry__.py::dryrun_multichip``
— runs one data-parallel train step of the flagship Darknet-19 on ``n``
ranks, one process each (``parallel/collectives.py::run_ranks``), and prints
``dryrun_multichip(n): backbone Darknet total loss … OK``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .category import load_anchors_file
from .data.transform import TrainAugment
from .models.darknet import Darknet
from .models.inference import Inference
from .ops.loss import LossConfig
from .ops.postprocess import postprocess
from .parallel.collectives import rank, run_ranks
from .parallel.mesh import batch_slice, make_train_step
from .utils.train import Optimizer

__all__ = ["entry", "flagship", "dryrun_multichip"]

ANCHORS = Path(__file__).resolve().parents[1] / "config" / "anchors" / "voc.tsv"


def flagship(num_classes: int = 20, dtype=torch.bfloat16) -> Darknet:
    """Darknet-19 YOLOv2 with VOC's anchors and ``pallas = nms fusedpost``."""
    return Darknet(anchors=load_anchors_file(str(ANCHORS)), num_classes=num_classes, dtype=dtype,
                   pallas=frozenset({"nms", "fusedpost"}))


def entry(device="cuda"):
    """(fn, (folded, images)): forward → decode → postprocess(threshold 0.005,
    overlap 0.45, topk 100) on Darknet-19 at 416, a batch of 8 zero images."""
    model = flagship()
    params, state = model.init(torch.Generator().manual_seed(0), device)
    inference = Inference(model)
    folded = inference.fold(params, state)

    def fn(folded, images):
        det = inference(folded, images)
        return postprocess(det, threshold=0.005, overlap=0.45, topk=100)

    images = torch.zeros((8, 416, 416, 3), dtype=torch.float32, device=device)
    return fn, (folded, images)


def _dryrun_rank(group, n_devices: int, device: str) -> dict:
    """One rank of :func:`dryrun_multichip`: its rows of the global batch
    through the fused augmentation and the step; returns the total loss and
    a checksum of the new params."""
    if torch.distributed.get_backend(group) == "nccl":       # one card a rank
        device = f"cuda:{rank(group)}"
        torch.cuda.set_device(device)
    model = flagship(dtype=torch.float32)
    params, state = model.init(torch.Generator().manual_seed(0), device)
    # optax.chain(clip_by_global_norm(5), sgd(1e-3, momentum=0.9)), as the JAX dry run
    optimizer = Optimizer("sgd", schedule=lambda count: 1e-3, clip=5.0, momentum=0.9)
    weights = {"coord": 1.0, "object": 5.0, "noobject": 1.0, "cls": 1.0, "prior": 0.01}
    augment = TrainAugment()
    step = make_train_step(model, optimizer, weights, LossConfig(), augment=augment, group=group)

    b, c, g, size = n_devices, 96, 4, 64
    rng = np.random.default_rng(0)
    center = rng.uniform(0.3, 0.7, (b, g, 2)).astype(np.float32)
    half = rng.uniform(0.05, 0.2, (b, g, 2)).astype(np.float32)
    batch = {"canvas": rng.integers(0, 255, (b, c, c, 3), dtype=np.uint8),
             "hw": np.full((b, 2), 64, np.float32),
             "yx_min": np.clip(center - half, 0, 1), "yx_max": np.clip(center + half, 0, 1),
             "cls": rng.integers(0, 20, (b, g)).astype(np.int32),
             "valid": np.ones((b, g), bool)}
    mine = {k: torch.from_numpy(v).to(device) for k, v in batch_slice(batch, group).items()}
    draws = batch_slice(augment.draw(torch.Generator().manual_seed(1), b), group)
    params, state, _, metrics = step(params, state, optimizer.init(params), mine, 0, draws, size)
    checksum = sum(float(v.double().sum()) for lp in params.values() for v in lp.values())
    return {"total": float(metrics["total"]), "checksum": checksum}


def dryrun_multichip(n_devices: int, device: str = "cuda", backend: str | None = None) -> None:
    """One data-parallel train step of the flagship Darknet-19 (f32, 64²
    input from a 96² canvas, 4 boxes an image, one image a rank, the fused
    augmentation, the gradient clipped at 5, SGD with momentum 0.9) on
    ``n_devices`` ranks.

    ``device="cuda"``: ``backend`` NCCL by default, one card a rank, which
    needs ``n_devices`` cards; ``backend="gloo"`` places every rank on
    ``cuda:0``.  ``device="cpu"``: gloo on the CPU.  Raises where the ranks
    disagree or a loss is not finite."""
    if device == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"dryrun_multichip: device cpu takes backend gloo, not {backend!r}")
        backend = "gloo"
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: torch sees no CUDA device; pass device='cpu'")
        cards = torch.cuda.device_count()
        if backend is None:
            if cards < n_devices:
                raise RuntimeError(f"dryrun_multichip({n_devices}): NCCL needs one card a "
                                   f"rank and there are {cards}; pass backend='gloo' to place "
                                   "every rank on cuda:0")
            backend = "nccl"
        elif backend not in ("nccl", "gloo"):
            raise ValueError(f"dryrun_multichip: unknown backend {backend!r}")
    else:
        raise ValueError(f"dryrun_multichip: device is 'cuda' or 'cpu', not {device!r}")
    results = run_ranks(_dryrun_rank, n_devices, n_devices, device, backend=backend)
    total = results[0]["total"]
    if any(r != results[0] for r in results) or not np.isfinite(total):
        raise AssertionError(f"dryrun_multichip({n_devices}): the ranks ended with {results}")
    print(f"dryrun_multichip({n_devices}): backbone {type(flagship()).__name__} "
          f"total loss {total:.4f} OK", flush=True)
