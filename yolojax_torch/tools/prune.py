"""Channel pruning by BatchNorm-γ magnitude (network slimming) —
counterpart of ``yolojax/tools/prune.py``.

Rank channels by |γ| across all prunable convs (one global rank-based
threshold), keep the strongest fraction, then walk the model *plan* slicing
weights so that every downstream consumer (sequential convs, depthwise
convs tied to their input, reorg channel expansion, passthrough concat)
receives exactly its surviving inputs.  Emits (a) slimmed params and state
and (b) the ``{layer: width}`` dict that ``models.ChannelResolver`` feeds
back into model construction (``[model] channels``).

The port's layouts: conv weights OIHW, a depthwise conv ``(C, 1, 3, 3)``
whose channels follow its input.  The ranking and the walk are the
reference's; the slicing runs on the tensors' own device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["prune", "save_channels", "gamma_concentration"]


def _rank_threshold(gammas: np.ndarray, ratio: float) -> float:
    """|γ| value at the ``ratio``-removal rank: channels >= it are KEPT.

    Rank-based (``np.partition``), not ``np.quantile``: quantile
    interpolation at a tie run (e.g. many exactly-zero γ) can land strictly
    inside the run and shift how many channels go.  Ties AT the threshold
    are kept, so a tie run never removes more than asked.
    """
    n_remove = min(int(round(ratio * len(gammas))), len(gammas) - 1)
    return float(np.partition(gammas, n_remove)[n_remove])


def _abs_gamma(params, d) -> np.ndarray:
    return np.abs(params[d.name]["gamma"].detach().cpu().numpy())


def _prunable(model, skip: frozenset):
    return [d for d in model.layer_defs if d.bn and d.groups == 1 and d.name not in skip]


def _keep_indices(params, prunable, ratio: float):
    """Global |γ| ranking → per-layer kept channel indices (sorted).
    ``ratio`` is the fraction REMOVED."""
    threshold = _rank_threshold(np.concatenate([_abs_gamma(params, d) for d in prunable]), ratio)
    keep = {}
    for d in prunable:
        g = _abs_gamma(params, d)
        idx = np.nonzero(g >= threshold)[0]
        if len(idx) == 0:  # never kill a layer entirely
            idx = np.asarray([int(g.argmax())])
        keep[d.name] = idx
    return keep


def _full_width_skip(model, skip=("out",)) -> set:
    """Layers that must keep full width: the head's final conv (its channels
    are the anchor fields) plus, under darknet reorg semantics, each conv
    feeding a reorg — darknet's reorg reinterprets the (C, H, W) buffer, so
    output channels mix input channels across rows and per-channel pruning
    cannot propagate through it (the feeder's 64 channels are <1 % of the
    model's params)."""
    skip = set(skip)
    if getattr(model, "reorg_order", "darknet") == "darknet":
        last_conv = None
        for op in model.plan:
            if op[0] == "conv":
                last_conv = op[1].name
            elif op[0] == "reorg" and last_conv is not None:
                skip.add(last_conv)
    return skip


def gamma_concentration(model, params, ratio: float, skip=("out",)) -> float:
    """Fraction of the total prunable |γ| mass held by the KEPT ``1 - ratio``
    channels under the ranking :func:`prune` uses: → 1 when sparsity
    training has pushed the unimportant γ to zero, ≈ ``1 - ratio`` when |γ|
    is uniform and the ranking carries no information."""
    prunable = _prunable(model, frozenset(_full_width_skip(model, skip)))
    g = np.concatenate([_abs_gamma(params, d) for d in prunable])
    threshold = _rank_threshold(g, ratio)
    return float(g[g >= threshold].sum() / max(g.sum(), 1e-12))


def _take(t: torch.Tensor, dim: int, idx: np.ndarray) -> torch.Tensor:
    return t.index_select(dim, torch.as_tensor(idx, dtype=torch.long, device=t.device))


def prune(model, params, state, ratio: float, skip=("out",)):
    """Prune ``ratio`` of BN channels → (params, state, channels dict).

    ``ratio`` is the fraction REMOVED (0.3 → keep 70 %). ``skip`` layers keep
    full width (the head's final conv must: its channels are the anchor
    fields)."""
    skip = _full_width_skip(model, skip)
    order = getattr(model, "reorg_order", "darknet")
    keep = _keep_indices(params, _prunable(model, frozenset(skip)), ratio)

    new_params, new_state, channels = {}, {}, {}
    in_idx = np.arange(3)       # surviving input channels, original ids
    orig_ch = 3                 # original channel count of the running tensor
    slots: dict[str, tuple[np.ndarray, int]] = {}

    for op in model.plan:
        kind = op[0]
        if kind == "conv":
            d = op[1]
            p = dict(params[d.name])
            s = dict(state.get(d.name, {}))
            if d.groups > 1:  # depthwise: out channels tied to inputs
                out_idx = in_idx
                p["w"] = _take(p["w"], 0, in_idx)
            else:
                out_idx = keep.get(d.name, np.arange(d.out_ch))
                p["w"] = _take(_take(p["w"], 1, in_idx), 0, out_idx)
            for k in ("gamma", "beta", "b"):
                if k in p:
                    p[k] = _take(p[k], 0, out_idx)
            for k in ("mean", "var"):
                if k in s:
                    s[k] = _take(s[k], 0, out_idx)
            new_params[d.name] = p
            if s:
                new_state[d.name] = s
            if d.name in keep:  # depthwise widths follow their input in the builders
                channels[d.name] = int(len(out_idx))
            in_idx = out_idx
            orig_ch = d.out_ch  # a depthwise conv's equals its input's
        elif kind == "mark":
            slots[op[1]] = (in_idx, orig_ch)
        elif kind == "load":
            in_idx, orig_ch = slots[op[1]]
        elif kind == "reorg":
            s2 = op[1] * op[1]
            if order == "darknet":
                # the feeder conv was kept at full width above, so the reorg
                # is a fixed bijection: all output channels survive in order
                if len(in_idx) != orig_ch:
                    raise ValueError("a darknet-order reorg's input must be unpruned")
                in_idx = np.arange(orig_ch * s2)
            else:
                # s2d: the pruned tensor's channels are offset-major over the
                # kept channels; map back to original ids (p*s+q)*C_orig + c
                in_idx = np.concatenate([o * orig_ch + in_idx for o in range(s2)])
            orig_ch *= s2
        elif kind == "concat":
            slot_idx, slot_orig = slots[op[1]]
            in_idx = np.concatenate([in_idx, slot_idx + orig_ch])
            orig_ch += slot_orig

    return new_params, new_state, channels


def save_channels(path: str, channels: dict) -> None:
    with open(path, "w") as f:
        json.dump(channels, f, indent=0, sort_keys=True)
