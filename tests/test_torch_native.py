"""Port parity, the host C++ NMS: ``yolojax_torch.native`` against
``yolojax.native`` and ``yolojax.ops.nms.nms_select`` (JAX's and the
port's plain one) on the CPU.

The two libraries compile the same greedy loop, so on distinct scores idx,
conf and count must be identical, not close; against the greedy loops of
``nms_select`` the picks are identical and conf is the same f32 score.
Where the reference's library departs from ``nms_select`` the port's does
not: equal scores go lowest index first (the reference's ``std::sort`` is
not stable), and an IoU equal to ``overlap`` does not suppress (g++
contracts the reference's union into an FMA; the port builds with
``-ffp-contract=off``).  The port builds into ``build/yolojax_torch/``
(never ``~/.cache``) and raises where the library is missing, as the
reference does.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

import torch

from yolojax import native as jnative
from yolojax.ops.nms import nms_select
from yolojax_torch import native
from yolojax_torch.kernels._build import BUILD_DIR
from yolojax_torch.ops.iou import iou_pairwise
from yolojax_torch.ops.nms import nms_select as plain_nms_select

from torch_port_families import load_reference_native, reference_native_library

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def toolchain():
    """Both libraries loaded; a skip only where there is no g++ at all: with g++
    present a failed build fails the test."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    assert native.native_nms_available(), native._error
    load_reference_native()


def problems(rng, g, n, disjoint=False):
    center = rng.uniform(0.2, 0.8, (g, n, 2)).astype(np.float32)
    half = rng.uniform(0.05, 0.2, (g, n, 2)).astype(np.float32)
    boxes = np.concatenate([center - half, center + half], -1)
    if disjoint:
        boxes += np.arange(n, dtype=np.float32)[None, :, None]
    return boxes, rng.uniform(0, 1, (g, n)).astype(np.float32)


TIE_SORT = ("[&](int32_t a, int32_t b) { return scores[a] > scores[b]; });",
            "[&](int32_t a, int32_t b) {\n"
            "              return scores[a] > scores[b] || (scores[a] == scores[b] && a < b);\n"
            "            });")


def test_source_is_the_reference_text_but_the_tie_order():
    ours = (ROOT / "yolojax_torch/native/nms.cpp").read_text()
    ref = (ROOT / "yolojax/native/nms.cpp").read_text()
    ref = ref[ref.index("#include <algorithm>"):]
    assert ref.count(TIE_SORT[0]) == 1
    assert ours[ours.index("#include <algorithm>"):] == ref.replace(*TIE_SORT)
    assert "-ffp-contract=off" in native.GXX_FLAGS


def test_library_builds_under_the_repo_build_dir():
    lib = native.build()
    assert lib.parent == BUILD_DIR and lib.exists()
    assert lib == native.library_path()


def test_the_reference_library_loads_after_a_lost_build_race(tmp_path, monkeypatch):
    """The state a worker is left in when another overwrote its build: the
    failure remembered and a broken ``.so`` at the reference's path."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    so = reference_native_library()
    assert so.is_relative_to(tmp_path)
    so.parent.mkdir(parents=True)
    so.write_bytes(b"not a library")
    assert not jnative.native_nms_available()
    assert load_reference_native() is jnative and jnative.native_nms_available()
    assert so.read_bytes().startswith(b"\x7fELF")


@pytest.mark.parametrize("g,n,max_out,threshold,overlap",
                         [(16, 50, 20, 0.3, 0.45), (40, 845, 100, 0.005, 0.45),
                          (8, 80, 80, 0.0, 0.3), (3, 1, 5, 0.5, 0.45), (5, 200, 300, 0.2, 0.7)])
def test_batch_identical_to_the_reference(rng, g, n, max_out, threshold, overlap):
    boxes, scores = problems(rng, g, n)
    got = native.nms_native_batch(boxes, scores, threshold, overlap, max_out)
    want = jnative.nms_native_batch(boxes, scores, threshold, overlap, max_out)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_batch_picks_equal_the_jax_greedy_loop(rng):
    boxes, scores = problems(rng, 12, 60)
    idx, conf, count = native.nms_native_batch(boxes, scores, 0.3, 0.45, 20)
    for k in range(len(boxes)):
        ri, rc, rv = nms_select(boxes[k, :, :2], boxes[k, :, 2:], scores[k], 0.3, 0.45, 20)
        kk = int(np.asarray(rv).sum())
        assert count[k] == kk
        np.testing.assert_array_equal(idx[k, :kk], np.asarray(ri)[:kk])
        np.testing.assert_array_equal(conf[k, :kk], np.asarray(rc)[:kk])


def test_single_problem_matches_the_reference(rng):
    boxes, scores = problems(rng, 1, 30, disjoint=True)
    scores = np.linspace(0.9, 0.05, 30).astype(np.float32)[None]
    got = native.nms_native(boxes[0, :, :2], boxes[0, :, 2:], scores[0], 0.5, 0.45, 10)
    want = jnative.nms_native(boxes[0, :, :2], boxes[0, :, 2:], scores[0], 0.5, 0.45, 10)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert int(got[2].sum()) == min(int((scores > 0.5).sum()), 10)


def test_shape_mismatch_raises(rng):
    boxes, scores = problems(rng, 2, 10)
    with pytest.raises(ValueError, match="expected"):
        native.nms_native_batch(boxes[:, :5], scores, 0.3, 0.45, 5)


def test_unavailable_library_raises(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "g++ missing")
    assert not native.native_nms_available()
    with pytest.raises(RuntimeError, match="unavailable: g\\+\\+ missing"):
        native.nms_native_batch(np.zeros((1, 2, 4), np.float32), np.zeros((1, 2), np.float32),
                                0.5, 0.45, 2)


def _plain_picks(boxes, scores, threshold, overlap, max_out):
    idx, conf, valid = plain_nms_select(torch.from_numpy(boxes[..., :2]),
                                        torch.from_numpy(boxes[..., 2:]),
                                        torch.from_numpy(scores), threshold, overlap, max_out)
    return idx.numpy(), conf.numpy(), valid.sum(-1).numpy()


def test_equal_scores_go_lowest_index_first(rng):
    """Scores from three values, so most candidates tie: the picks are
    ``nms_select``'s (JAX's and the port's plain one) slot for slot."""
    boxes, _ = problems(rng, 6, 300)
    scores = rng.choice(np.float32([1.0, 0.9, 0.5]), (6, 300))
    idx, conf, count = native.nms_native_batch(boxes, scores, 0.005, 0.45, 100)
    pidx, pconf, pcount = _plain_picks(boxes, scores, 0.005, 0.45, 100)
    np.testing.assert_array_equal(count, pcount)
    for k in range(len(boxes)):
        n = count[k]
        np.testing.assert_array_equal(idx[k, :n], pidx[k, :n])
        np.testing.assert_array_equal(conf[k, :n], pconf[k, :n])
        ri, _, rv = nms_select(boxes[k, :, :2], boxes[k, :, 2:], scores[k], 0.005, 0.45, 100)
        np.testing.assert_array_equal(idx[k, :n], np.asarray(ri)[:n])


def test_an_iou_equal_to_overlap_does_not_suppress(rng):
    """Pairs of overlapping boxes with ``overlap`` set to their IoU as the
    plain NMS computes it (separate f32 ops, as the card's kernel): the
    second box is not suppressed (``iou > overlap`` is false), for every
    pair, as in the plain NMS."""
    boxes, _ = problems(rng, 400, 2)
    iou = iou_pairwise(torch.from_numpy(boxes[:, 0, :2]), torch.from_numpy(boxes[:, 0, 2:]),
                       torch.from_numpy(boxes[:, 1, :2]), torch.from_numpy(boxes[:, 1, 2:]))
    scores = np.float32([[0.9, 0.8]])
    for k in np.nonzero(iou.numpy() > 0.05)[0][:200]:
        overlap = float(iou[k])
        _, _, count = native.nms_native_batch(boxes[k:k + 1], scores, 0.1, overlap, 2)
        _, _, pcount = _plain_picks(boxes[k:k + 1], scores, 0.1, overlap, 2)
        assert count[0] == pcount[0] == 2, (k, overlap)
