"""The port's one place that touches ``torch.distributed``.

The JAX package shards its train step and its eval over a data mesh
(``yolojax/parallel/mesh.py``) and lets GSPMD insert the reductions.  The
port runs one process per device in a ``torch.distributed`` process group
and makes each reduction explicit, with the helpers below:

* :func:`world` / :func:`rank` — 1 and 0 with no group (one process);
* :func:`local_world` — the ranks of this machine, the JAX package's
  process (the train CLI's batch unit);
* :func:`init_from_env` — the group torchrun describes (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), or the
  default group a caller already started;
* :func:`all_reduce_sum` — a sum over the group that autograd goes through
  (the backward sums the gradients over the group too), for the BN
  statistics of the global batch;
* :func:`average_grads` and :func:`average` — gradients and metrics
  averaged over the group;
* :func:`gather_to_rank0` / :func:`broadcast_from_rank0` — host objects;
* :func:`run_ranks` — spawn a group of processes on one machine and
  collect what each returns (tests, the dry run, the smoke run).

Under gloo a CUDA tensor is copied to the host, reduced there and copied
back: that is an explicit path for gloo, taken whenever the group's backend
is gloo and the tensor lies on a card (gloo's own staging of CUDA tensors is
not in every build).  It is how several ranks share one card, where NCCL
refuses two ranks on one device.  NCCL reduces on the card.
"""

from __future__ import annotations

import datetime
import os
import socket
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

__all__ = ["world", "rank", "local_world", "init_from_env", "all_reduce_sum", "average_grads",
           "average", "gather_to_rank0", "broadcast_from_rank0", "run_ranks"]

TIMEOUT = datetime.timedelta(seconds=300)   # a collective waiting on a dead peer gives up


def world(group=None) -> int:
    """The number of ranks in ``group``; 1 with no group."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    """This process's rank in ``group``; 0 with no group."""
    return 0 if group is None else dist.get_rank(group)


def local_world(group=None) -> int:
    """The ranks of ``group`` on this machine: torchrun's
    ``LOCAL_WORLD_SIZE``, else the whole group (every rank on one machine,
    as ``run_ranks`` starts them); 1 with no group."""
    if group is None:
        return 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world(group)))


def init_from_env(device) -> tuple:
    """(group, this rank's device).

    Where a default group exists (a test or the smoke run started one), it is
    the group and ``device`` stays as given.  Else, where torchrun's
    ``WORLD_SIZE`` is above 1, the default group is started from ``RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``: NCCL for a CUDA device, which then
    means ``cuda:LOCAL_RANK``, gloo for the CPU.  A missing variable raises.
    Else there is one process, and the group is None.  A group of one rank
    is None too, so one process always takes the one-device path."""
    device = torch.device(device)
    if not dist.is_initialized():
        size = int(os.environ.get("WORLD_SIZE", "1"))
        if size <= 1:
            return None, device
        missing = [k for k in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"WORLD_SIZE={size} but {', '.join(missing)} not set: start the "
                               "ranks with torchrun, which sets them")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            world_size=size, rank=int(os.environ["RANK"]), timeout=TIMEOUT)
    group = dist.group.WORLD
    return (group if world(group) > 1 else None), device


def _on_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _sum_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over the group, in place; through the host under gloo."""
    if _on_host(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _sum_(grad.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the group, as a new tensor; its gradient is the sum
    of every rank's gradient of its output, which is what each rank's share
    of a loss summed over the ranks needs."""
    return _AllReduceSum.apply(x, group)


def average_grads(grads: dict, group) -> dict:
    """``{layer: {name: tensor}}`` averaged over the group: the leaves of each
    dtype flattened into one buffer, one sum over the group per buffer, then
    divided by the world size.  Returns new tensors."""
    leaves = [(k, n, v) for k, lp in grads.items() for n, v in lp.items()]
    out = {k: {} for k in grads}
    for dtype in dict.fromkeys(v.dtype for _, _, v in leaves):
        mine = [(k, n, v) for k, n, v in leaves if v.dtype == dtype]
        flat = _sum_(torch.cat([v.reshape(-1) for _, _, v in mine]), group)
        flat /= world(group)
        for (k, n, v), piece in zip(mine, flat.split([v.numel() for _, _, v in mine])):
            out[k][n] = piece.view(v.shape)
    return out


def average(values: dict, group) -> dict:
    """``{name: 0-d tensor}`` (one dtype) averaged over the group with one sum."""
    names = list(values)
    flat = _sum_(torch.stack([values[k] for k in names]), group) / world(group)
    return dict(zip(names, flat.unbind()))


def gather_to_rank0(obj, group) -> list | None:
    """Every rank's picklable ``obj``, in rank order, on rank 0; None on the
    others.  ``[obj]`` with no group."""
    if group is None:
        return [obj]
    out = [None] * world(group) if rank(group) == 0 else None
    dist.gather_object(obj, out, dst=dist.get_global_rank(group, 0), group=group)
    return out


def broadcast_from_rank0(obj, group):
    """Rank 0's picklable ``obj`` on every rank (``obj`` itself with no group)."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(index: int, fn, size: int, backend: str, port: int, out: str, args) -> None:
    torch.set_num_threads(max(1, torch.get_num_threads() // size))   # the ranks share the host
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=size,
                            rank=index, timeout=TIMEOUT)
    try:
        result = fn(dist.group.WORLD, *args)
        torch.save(result, Path(out) / f"{index}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, size: int, *args, backend: str = "gloo") -> list:
    """Spawn ``size`` processes on this machine, in one group on
    ``127.0.0.1`` (``backend``), each of which calls ``fn(group, *args)``;
    returns their results in rank order.  ``fn`` and ``args`` are pickled
    (``fn`` by its import path) and each result is sent back through a file;
    a rank that raises makes this raise, after the others are stopped."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out:
        mp.start_processes(_rank_main, (fn, size, backend, _free_port(), out, args),
                           nprocs=size, join=True, start_method="spawn")
        return [torch.load(Path(out) / f"{i}.pt", weights_only=False) for i in range(size)]
