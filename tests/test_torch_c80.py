"""``python -m yolojax_torch.tools.c80_fusedpost`` against
``scripts/c80_fusedpost.py``'s two routes, on the CPU.

Full-width Darknet-19 with 80 classes at 64², B=2, float32, one set of
numpy weights (He-normal convs, random BN statistics, γ and β:
``torch_port_families.numpy_weights``; the head's objectness weights ×200
and class weights ×16, so that some of a 64² head's scores clear the
threshold) carried into the port by ``checkpoint.from_jax``, the
objectness logit at −6 in both, BN folded:

* fused: the tool's ``detect_fn`` closure under ``nms fusedpost`` against
  the JAX package's forward + ``postprocess_fused_pallas``;
* separate: under ``nms`` against its ``Inference`` (forward + decode) +
  ``postprocess_pallas``;

the Pallas kernels in interpret mode, as ``tests/test_kernels.py`` runs
them.  ``keep`` (so every (image, class) keep count) exact, ``conf`` rtol
1e-4 and the corners atol 1e-4 on the kept slots, the bounds of
``tests/test_torch_inference.py`` (the heads agree to ~1e-5 after 23
convolutions summed in other orders).  Then the tool's own comparison of
its two routes, and its JSON line under ``--device cpu``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_port_families import numpy_weights
from yolojax.kernels.nms import postprocess_fused_pallas, postprocess_pallas
from yolojax.models.inference import Inference as JInference
from yolojax_torch.tools import c80_fusedpost
from yolojax_torch.utils.checkpoint import from_jax

SIZE, BATCH = 64, 2


@pytest.fixture(scope="module")
def routes():
    """The JAX package's two routes' outputs and the tool's, on one batch."""
    from __graft_entry__ import _flagship

    rng = np.random.default_rng(80)
    jmodel = _flagship(num_classes=c80_fusedpost.CLASSES, dtype=jnp.float32)
    model, _, _ = c80_fusedpost.setup("cpu", dtype=torch.float32)
    params, state = numpy_weights(rng, model, gamma=(0.5, 1.0))
    # a 64² head's features are small: scale its objectness and class weights
    # so that some scores clear the threshold at the objectness logit −6
    head = params["out"]["w"].reshape(-1, len(jmodel.anchors), 5 + c80_fusedpost.CLASSES)
    head[..., 4] *= 200
    head[..., 5:] *= 16
    params["out"]["b"].reshape(-1, 5 + c80_fusedpost.CLASSES)[:, 4] = c80_fusedpost.OBJECTNESS
    x = rng.uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)

    jinf = JInference(jmodel)
    jfolded = jinf.fold(params, state)
    args = (c80_fusedpost.THRESHOLD, c80_fusedpost.OVERLAP, c80_fusedpost.TOPK)
    with pltpu.force_tpu_interpret_mode():
        raw = jmodel.apply_folded(jfolded, jnp.asarray(x))
        want = {"fused": postprocess_fused_pallas(raw, np.asarray(jmodel.anchors), *args),
                "separate": postprocess_pallas(jinf(jfolded, jnp.asarray(x)), *args)}

    model, folded, runs = c80_fusedpost.setup("cpu", torch.float32, *from_jax(params, state))
    got = {name: run(folded, torch.from_numpy(x)) for name, run in runs.items()}
    return want, got


@pytest.mark.parametrize("route", sorted(c80_fusedpost.ROUTES))
def test_route_matches_the_jax_package(routes, route):
    want, got = (r[route] for r in routes)
    keep = np.asarray(want.keep)
    assert got.keep.shape == keep.shape == (BATCH, c80_fusedpost.CLASSES, c80_fusedpost.TOPK)
    assert keep.sum() > 0
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_allclose(np.where(keep, got.conf.numpy(), 0),
                               np.where(keep, np.asarray(want.conf), 0), rtol=1e-4)
    for name in ("yx_min", "yx_max"):
        np.testing.assert_allclose(np.where(keep[..., None], getattr(got, name).numpy(), 0),
                                   np.where(keep[..., None], np.asarray(getattr(want, name)), 0),
                                   atol=1e-4, err_msg=name)


def test_the_two_routes_keep_the_same_boxes(routes):
    _, got = routes
    same = c80_fusedpost.compare_routes(got["fused"], got["separate"])
    kept = int(got["fused"].keep.sum())
    assert same["same_keep"] and same["kept_fused"] == same["kept_separate"] == kept > 0
    assert same["max_conf_diff"] <= 1e-6 and same["max_corner_diff"] <= 1e-6


def test_the_cli_prints_its_json_line_on_the_cpu(capsys):
    assert c80_fusedpost.main(["--device", "cpu", "--size", str(SIZE), "--batches", "2",
                               "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    line = json.loads(lines[-1])
    assert line["device"] == "cpu" and line["classes"] == 80 and list(line["batches"]) == ["2"]
    row = line["batches"]["2"]
    for route, kernel in c80_fusedpost.KERNELS.items():
        r = row[route]
        assert r["post_kernel"] == kernel and r["post_device_us"] is None   # not measured
        assert r["launches_per_call"] == {"postprocess_fused": 0, "nms_select": 0}  # plain
        assert r["ms"] > 0 and r["img_per_s"] > 0 and r["first_s"] > 0
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")
    assert row["same_boxes"]["same_keep"]
    dense = row["same_boxes_init_objectness"]
    assert dense["same_keep"] and dense["kept_fused"] == dense["kept_separate"] > 0
    assert any(f"B=2 {route}" in text for text in lines for route in c80_fusedpost.ROUTES)
