"""The train CLI's batch unit: ``[data] batch_size`` is the node's, as it is
the process's in the JAX package.

The JAX package's one process drives every chip of its host and splits
``batch_size`` over them (``yolojax/parallel/mesh.py::make_mesh_for_batch``);
the port runs one process per card, and a rank takes ``batch_size //
LOCAL_WORLD_SIZE``.  From one ini, one cache and one npz checkpoint,
``data/batch_size=4``, no augmentation, a fixed 64² input, float32:

* the JAX package's ``Train`` in this process, its mesh over 4 of the 8
  host devices of ``conftest.py``;
* the port's ``Train`` on two gloo ranks (``tests/torch_dist_ranks.py``)
  with ``LOCAL_WORLD_SIZE=2``.

Both take 4 images a step (2 a rank in the port), the same steps an epoch
and the same ``seen``, and after two steps the same params to rtol 1e-4
(atol 1e-6), the bound ``test_torch_train_cli.py`` holds two ranks to one
process with, and the same change of the params over the two steps to
1e-2 (‖Δport − Δjax‖ / ‖Δjax‖ over the model, the bound of
``test_torch_train_step.py``, where the two libraries' float32
convolutions and BN sums round apart).  A batch that does not split over
the node's ranks raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_train_cli import ANCHORS, model_dir, workspace  # noqa: F401
from yolojax.models.darknet import Tiny as JaxTiny
from yolojax.utils import checkpoint as jckpt
from yolojax_torch.utils import checkpoint as ckpt

STEPS = 2
MODS = ["data/batch_size=4", "train/learning_rate=1e-3", "transform/train=", "transform/dtype=float32",
        "train/multi_scale_min=64", "train/multi_scale_max=64", "train/prewarm=0",
        "train/warmup_seen=100", "summary/histogram=1000", "summary/image=1000"]


def _start(root) -> str:
    """The JAX package's seeded Tiny (the workspace's two classes and
    anchors) as an npz both packages finetune from."""
    params, state = JaxTiny(anchors=ANCHORS, num_classes=2, dtype=jnp.float32).init(
        jax.random.PRNGKey(5))
    path = str(root / "batch_unit_start.npz")
    jckpt.save(path, {"params": params, "state": state}, {})
    return path


def _argv(cfg, start, name: str, *extra) -> list:
    return cfg + ["-f", start, "--steps", str(STEPS), "-m", *MODS, f"model/name={name}", *extra]


def test_a_node_batch_splits_over_its_ranks_as_over_the_reference_chips(workspace, monkeypatch):
    import torch_dist_ranks

    from yolojax.cli import setup as jax_setup
    from yolojax.cli.train import Train as JaxTrain
    from yolojax_torch.cli.train import train_parser
    from yolojax_torch.parallel.collectives import run_ranks

    root, cfg = workspace
    start = _start(root)
    args = train_parser().parse_args(_argv(cfg, start, "batch-ref"))
    ref = JaxTrain(args, jax_setup(args))
    assert ref.batch_size == 4 and ref.mesh.devices.size == 4
    ref(max_steps=STEPS)

    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    ranks = run_ranks(torch_dist_ranks.train_cli, 2,
                      _argv(cfg, start, "batch-port", "--device", "cpu"))
    assert [r["batch"] for r in ranks] == [2, 2]               # 4 images a step, 2 a rank
    assert [r["steps_per_epoch"] for r in ranks] == [ref.steps_per_epoch] * 2
    assert [(r["step"], r["seen"]) for r in ranks] == [(STEPS, ref.seen)] * 2
    assert ref.seen == 4 * STEPS and ranks[0]["digest"] == ranks[1]["digest"]

    want, want_meta = ckpt.load(str(model_dir(root).parent / "batch-ref" / f"{STEPS}.npz"),
                                ("params",))
    got, meta = ckpt.load(str(model_dir(root).parent / "batch-port" / f"{STEPS}.npz"),
                          ("params",))
    assert meta == want_meta == {"step": STEPS, "seen": 4 * STEPS}
    start_params = ckpt.load(start, ("params",))[0]["params"]
    diff = norm = 0.0
    for k, lp in want["params"].items():
        for n, v in lp.items():
            np.testing.assert_allclose(got["params"][k][n], v, rtol=1e-4, atol=1e-6,
                                       err_msg=f"params {k}.{n}")
            diff += float(np.sum((got["params"][k][n] - v) ** 2))
            norm += float(np.sum((v - start_params[k][n]) ** 2))
    assert norm > 0 and np.sqrt(diff / norm) < 1e-2, (diff, norm)


def test_a_node_batch_that_does_not_split_over_its_ranks_raises(workspace, monkeypatch):
    import torch_dist_ranks

    from yolojax_torch.parallel.collectives import run_ranks

    root, cfg = workspace
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(Exception, match="batch_size 3 does not split over the 2 ranks"):
        run_ranks(torch_dist_ranks.train_cli, 2,
                  cfg + ["--device", "cpu", "--steps", "1", "-m", "data/batch_size=3",
                         "train/prewarm=0", "model/name=batch-odd"])
