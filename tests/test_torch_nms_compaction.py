"""The contract of the greedy loop's threshold compaction, and the fused
wrapper's CPU path.

Both CUDA NMS kernels (``csrc/greedy_nms.cuh``) run greedy NMS only over the
candidates whose score is ``> threshold``, kept in index order with their
original indices.  These tests hold that compacted greedy, written here in
plain torch on top of ``ops.nms.nms_select``, to greedy over the whole row:
idx, conf and valid identical after the indices are mapped back.  The whole
row goes through ``yolojax_torch.ops.nms.nms_select`` and the JAX package's
``nms_select_pallas`` in interpret mode.  Exact: NMS compares and copies
scores, it computes none.  Rows cover ties, −inf and NaN scores, every
score below the threshold and every score above it.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from yolojax.kernels.nms import nms_select_pallas
from yolojax_torch.kernels import postprocess_fused as pf
from yolojax_torch.ops.nms import nms_select
from yolojax_torch.ops.postprocess import postprocess_raw

THRESHOLD, OVERLAP = 0.3, 0.45


def _boxes(rng, n):
    center = rng.uniform(0.2, 0.8, (n, 2)).astype(np.float32)
    half = rng.uniform(0.02, 0.25, (n, 2)).astype(np.float32)
    return center - half, center + half


def compacted_greedy(yx_min, yx_max, scores, threshold, overlap, max_out):
    """Greedy over the entries ``> threshold`` of each row, in index order,
    with the picks' list positions mapped back to the row's indices: the
    kernels' compaction, one row at a time."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    rows = scores.reshape(-1, n)
    bmin = yx_min.broadcast_to(*lead, n, 2).reshape(-1, n, 2)
    bmax = yx_max.broadcast_to(*lead, n, 2).reshape(-1, n, 2)
    idx = torch.zeros((rows.shape[0], max_out), dtype=torch.int32)
    conf = torch.zeros((rows.shape[0], max_out), dtype=torch.float32)
    valid = torch.zeros((rows.shape[0], max_out), dtype=torch.bool)
    for g, row in enumerate(rows):
        where = torch.nonzero(row > threshold).flatten()      # index order
        if not len(where):
            continue
        i, c, v = nms_select(bmin[g, where], bmax[g, where], row[where], threshold, overlap,
                             max_out)
        idx[g] = torch.where(v, where[i.long()].to(torch.int32), 0)
        conf[g], valid[g] = c, v
    shape = (*lead, max_out)
    return idx.reshape(shape), conf.reshape(shape), valid.reshape(shape)


def _row(rng, kind, n):
    s = rng.uniform(0, 1, n).astype(np.float32)
    if kind == "ties":              # every score repeats, some above the threshold
        s = rng.choice(np.float32([0.2, 0.5, 0.5, 0.9]), n)
    elif kind == "neg_inf":
        s[rng.uniform(size=n) < 0.3] = -np.inf
    elif kind == "nan":
        s[rng.uniform(size=n) < 0.1] = np.nan
    elif kind == "all_below":
        s = rng.uniform(0, THRESHOLD, n).astype(np.float32)
    elif kind == "all_above":
        s = rng.uniform(THRESHOLD + 1e-3, 1, n).astype(np.float32)
    elif kind == "at_threshold":    # == threshold fails > threshold
        s[::3] = np.float32(THRESHOLD)
    return s


def _same(got, want):
    for g, w, name in zip(got, want, ("idx", "conf", "valid")):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)


KINDS = ["random", "ties", "neg_inf", "all_below", "all_above", "at_threshold"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,max_out", [(40, 8), (97, 100)])
def test_compacted_greedy_matches_the_whole_row(rng, kind, n, max_out):
    """Against ops.nms.nms_select and the JAX Pallas kernel (interpret mode),
    three rows of one kind sharing their boxes."""
    import jax.numpy as jnp

    yx_min, yx_max = _boxes(rng, n)
    scores = np.stack([_row(rng, kind, n) for _ in range(3)])
    args = (torch.from_numpy(yx_min), torch.from_numpy(yx_max), torch.from_numpy(scores))
    got = compacted_greedy(*args, THRESHOLD, OVERLAP, max_out)
    _same(got, nms_select(*args, THRESHOLD, OVERLAP, max_out))
    bcast = lambda v: jnp.broadcast_to(jnp.asarray(v), (3, n, 2))
    with pltpu.force_tpu_interpret_mode():
        want = nms_select_pallas(bcast(yx_min), bcast(yx_max), jnp.asarray(scores), THRESHOLD,
                                 OVERLAP, max_out)
    _same(got, want)
    if kind == "all_below":
        assert not got[2].any()
    elif kind == "all_above":
        assert got[2][:, 0].all()


def test_compaction_with_nan_matches_the_kernels_rule(rng):
    """NaN fails ``> threshold``, so the compaction drops it, as the old
    block-wide loop never picked it (``keep_better``): the result is greedy
    over the row with NaN read as −inf."""
    n = 40
    yx_min, yx_max = (torch.from_numpy(a) for a in _boxes(rng, n))
    scores = torch.from_numpy(np.stack([_row(rng, "nan", n) for _ in range(3)]))
    assert scores.isnan().any()
    got = compacted_greedy(yx_min, yx_max, scores, THRESHOLD, OVERLAP, 8)
    _same(got, nms_select(yx_min, yx_max, scores.nan_to_num(nan=-math.inf), THRESHOLD, OVERLAP,
                          8))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), n=st.integers(1, 64), max_out=st.integers(1, 20),
       threshold=st.sampled_from([0.0, 0.3, 0.7]), overlap=st.sampled_from([0.0, 0.45, 0.9]),
       levels=st.integers(2, 8))
def test_compacted_greedy_matches_the_whole_row_hypothesis(seed, n, max_out, threshold,
                                                           overlap, levels):
    """Scores drawn from a few levels (so ties are common) and −inf."""
    rng = np.random.default_rng(seed)
    yx_min, yx_max = (torch.from_numpy(a) for a in _boxes(rng, n))
    values = np.append(np.linspace(0, 1, levels), -np.inf).astype(np.float32)
    scores = torch.from_numpy(rng.choice(values, (2, n)))
    got = compacted_greedy(yx_min, yx_max, scores, threshold, overlap, max_out)
    _same(got, nms_select(yx_min, yx_max, scores, threshold, overlap, max_out))


# -- the fused wrapper on the CPU, and its layout -----------------------------

@pytest.mark.parametrize("b,h,w,a,c,dtype", [
    (2, 13, 13, 5, 20, torch.float32), (2, 13, 13, 5, 20, torch.bfloat16),
    (1, 4, 3, 2, 3, torch.float32), (1, 4, 4, 5, 80, torch.bfloat16),
])
def test_fused_cpu_path_returns_the_plain_postprocessed(rng, monkeypatch, b, h, w, a, c, dtype):
    """The wrapper hands a CPU head to the plain version and returns its
    PostProcessed as it is, without a launch.  At the bench density
    (objectness −6) a second plain call gives the same values."""
    anchors = rng.uniform(0.5, 4.0, (a, 2)).astype(np.float32)
    raw = (rng.standard_normal((b, h, w, a * (5 + c))) * 2).astype(np.float32)
    raw.reshape(b, h, w, a, 5 + c)[..., 4] -= 6.0
    raw = torch.from_numpy(raw).to(dtype)
    calls = []

    def plain(*args):
        calls.append(args)
        calls.append(postprocess_raw(*args))
        return calls[-1]

    monkeypatch.setattr(pf, "postprocess_raw", plain)
    before = pf.postprocess_fused.launches
    got = pf.postprocess_fused(raw, anchors, 0.005, 0.45, 100)
    assert pf.postprocess_fused.launches == before
    assert len(calls) == 2 and calls[0][0] is raw and got is calls[1]
    want = postprocess_raw(raw, anchors, 0.005, 0.45, 100)
    assert type(got) is type(want)
    for g, v in zip(got, want):
        assert g.dtype == v.dtype and g.shape == v.shape
        torch.testing.assert_close(g, v, rtol=0, atol=0)


@pytest.mark.parametrize("n,c,group,smem", [
    (845, 20, 7, 62780),       # 416, VOC: three groups, three blocks an SM
    (1805, 20, 3, 76140),      # 608
    (845, 80, 8, 127600),      # COCO: the staged head rows set the size
    (24, 3, 3, 8864),          # a tiny grid: one group
])
def test_fused_layout_sizes_the_class_group_by_shared_memory(n, c, group, smem):
    assert pf.layout(n, c, 1024, 132) == (group, smem)      # a batch that fills the SMs
    assert smem == 4 * (4 * n + group * n + max(group * n, 256 * (5 + c)))
    groups = -(-c // group)
    assert -(-c // groups) == group          # evened out over the groups


@pytest.mark.parametrize("b,group", [(1, 1), (8, 1), (32, 3), (64, 5), (128, 7), (1024, 7)])
def test_fused_layout_spreads_a_small_batch_over_the_sms(b, group):
    """VOC at 416 on 132 SMs: about two blocks an SM, capped by shared memory."""
    assert pf.layout(845, 20, b, 132)[0] == group


def test_fused_layout_raises_past_the_opt_in_limit():
    with pytest.raises(ValueError, match="shared memory"):
        pf.layout(13 * 1024, 20, 8, 132)
