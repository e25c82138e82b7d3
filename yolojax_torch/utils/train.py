"""Optimizer and LR-schedule factories — counterpart of
``yolojax/utils/train.py``, resolved from the same config dotted paths
(``[train] optimizer = yolojax.utils.train.sgd`` names :func:`sgd` here).

The JAX package composes optax transforms; here one hand-written chain runs
over the dicts of tensors, in optax's order and with optax's meaning:

* sgd: clip by global norm (``[train] clip``) → ``+ sparsity·sign(γ)`` on BN
  scales (:func:`add_bn_l1`) → ``+ wd·p`` on conv kernels ``w`` only → the
  momentum trace ``t = g + m·t`` → ``−lr(count)·t``;
* adam: clip → L1 → Adam's scaled moments (b1 0.9, b2 0.999, eps 1e-8, bias
  corrected) → decoupled ``+ wd·p`` on ``w`` → ``−lr(count)·u`` (optax's
  ``adamw``).

``count`` is the number of updates made so far; the schedule reads it before
it is incremented.  Layers frozen by :func:`with_frozen` get zero updates,
keep no moment, and are left out of the clip's norm, as under optax's
``multi_transform``.

The optimizer state is a dict: ``count`` (an int) and the moment dicts
(``trace``, or ``mu`` and ``nu``) keyed like the params.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..config import parse_attr

__all__ = ["sgd", "adam", "step_schedule", "constant_schedule", "build_optimizer",
           "with_frozen", "add_bn_l1", "global_norm", "Optimizer"]


def step_schedule(config) -> Callable[[int], float]:
    """Piecewise-constant decay: × ``[train] gamma`` at each of ``[train]
    milestones``, counted as decayed from ``count == milestone`` on."""
    base = config.getfloat("train", "learning_rate", fallback=1e-3)
    gamma = config.getfloat("train", "gamma", fallback=0.1)
    raw = config.get("train", "milestones", fallback="").replace(",", " ").split()
    milestones = sorted({int(v) for v in raw})

    def schedule(count: int) -> float:
        lr = base
        for m in milestones:
            if count >= m:
                lr *= gamma
        return lr

    return schedule


def constant_schedule(config) -> Callable[[int], float]:
    base = config.getfloat("train", "learning_rate", fallback=1e-3)
    return lambda count: base


def _schedule(config):
    path = config.get("train", "scheduler", fallback="yolojax.utils.train.step_schedule")
    return parse_attr(path)(config)


def global_norm(tree: dict) -> torch.Tensor:
    """√(Σ leaf²) over a ``{layer: {name: tensor}}`` dict, as a 0-d tensor."""
    leaves = [v for lp in tree.values() for v in lp.values()]
    return torch.sqrt(sum(torch.sum(torch.square(v)) for v in leaves))


def add_bn_l1(updates: dict, params: dict, lam: float) -> dict:
    """Network-slimming sparsity: ``+ lam·sign(γ)`` on every ``gamma`` leaf
    (the L1 subgradient of ``lam·Σ|γ|``), every other leaf unchanged."""
    return {k: {n: u + lam * torch.sign(params[k][n]).to(u.dtype) if n == "gamma" else u
                for n, u in lp.items()} for k, lp in updates.items()}


def _map(fn, *trees):
    return {k: {n: fn(*(t[k][n] for t in trees)) for n in lp} for k, lp in trees[0].items()}


ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adamw's defaults


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The configured update chain (see the module docstring)."""

    kind: str                          # "sgd" | "adam"
    schedule: Callable[[int], float]
    clip: float = 0.0
    sparsity: float = 0.0
    weight_decay: float = 0.0
    momentum: float = 0.9
    frozen: frozenset = frozenset()

    def _trainable(self, tree: dict) -> dict:
        return {k: v for k, v in tree.items() if k not in self.frozen}

    def init(self, params: dict) -> dict:
        zeros = _map(torch.zeros_like, self._trainable(params))
        if self.kind == "sgd":
            return {"count": 0, "trace": zeros}
        return {"count": 0, "mu": zeros, "nu": _map(torch.zeros_like, zeros)}

    def step(self, grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        """(new params, new state); nothing given is modified."""
        g = self._trainable(grads)
        p = self._trainable(params)
        if self.clip > 0:
            norm = global_norm(g)
            g = _map(lambda t: torch.where(norm < self.clip, t, t / norm * self.clip), g)
        if self.sparsity > 0:
            g = add_bn_l1(g, p, self.sparsity)
        decay = lambda u, k, n: u + self.weight_decay * p[k][n] if n == "w" else u
        count = int(state["count"])
        if self.kind == "sgd":
            if self.weight_decay > 0:
                g = {k: {n: decay(u, k, n) for n, u in lp.items()} for k, lp in g.items()}
            trace = _map(lambda t, old: t + self.momentum * old, g, state["trace"])
            u, new_state = trace, {"count": count + 1, "trace": trace}
        else:
            mu = _map(lambda t, m: (1 - ADAM_B1) * t + ADAM_B1 * m, g, state["mu"])
            nu = _map(lambda t, v: (1 - ADAM_B2) * torch.square(t) + ADAM_B2 * v, g, state["nu"])
            c1, c2 = 1 - ADAM_B1 ** (count + 1), 1 - ADAM_B2 ** (count + 1)
            u = _map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS), mu, nu)
            u = {k: {n: decay(t, k, n) for n, t in lp.items()} for k, lp in u.items()}
            new_state = {"count": count + 1, "mu": mu, "nu": nu}
        lr = self.schedule(count)
        new_params = {k: {n: v + (-lr * u[k][n]) if k in u else v for n, v in lp.items()}
                      for k, lp in params.items()}
        return new_params, new_state


def _common(config) -> dict:
    return {"schedule": _schedule(config),
            "clip": config.getfloat("train", "clip", fallback=0.0),
            "sparsity": config.getfloat("train", "sparsity", fallback=0.0)}


def sgd(config) -> Optimizer:
    """SGD + momentum + weight decay on conv kernels (darknet's recipe)."""
    return Optimizer("sgd", weight_decay=config.getfloat("train", "weight_decay", fallback=5e-4),
                     momentum=config.getfloat("train", "momentum", fallback=0.9),
                     **_common(config))


def adam(config) -> Optimizer:
    """AdamW with the decoupled decay on conv kernels only."""
    return Optimizer("adam", weight_decay=config.getfloat("train", "weight_decay", fallback=0.0),
                     **_common(config))


def with_frozen(optimizer: Optimizer, params: dict, frozen_layers) -> Optimizer:
    """Freeze whole layers by name: they get zero updates and keep no moments."""
    del params  # the layers are named; the signature is the JAX package's
    return dataclasses.replace(optimizer, frozen=frozenset(frozen_layers))


def build_optimizer(config) -> Optimizer:
    factory = parse_attr(config.get("train", "optimizer", fallback="yolojax.utils.train.sgd"))
    return factory(config)
