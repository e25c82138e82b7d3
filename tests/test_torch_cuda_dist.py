"""The port's collectives, data-parallel step and device-resident dataset on
the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports torch, numpy, pytest and ``yolojax_torch`` only (with
``tests/torch_dist_ranks.py``, the rank bodies, which import the same), so
it runs on a machine without JAX (``chip_smoke.py`` runs it with the other
``tests/test_torch_cuda_*.py``):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda_*.py

* two gloo ranks on ``cuda:0`` (gloo sums a card's tensors through the
  host; NCCL refuses two ranks on one card), one f32 step of full-width
  Darknet-19 at 64² with the augmentation, B=2 a rank, TF32 off, against
  one process on the card on the global batch of 4: the loss components
  rtol 1e-5; ``grad_norm`` rtol 2e-4, as ``test_torch_cuda_train.py``
  holds one f32 step on the card against the CPU; the params' change and
  the BN state as ‖ranks − one‖ / ‖one‖ over the model within 2e-2 and
  1e-5, as ``chip_smoke.py``'s train phase holds one f32 step of
  full-width Darknet-19 on the card against the CPU (``TRAIN_PARITY``):
  the statistics and gradients meet in other orders, cuDNN's f32
  convolutions differ with the batch (2 a rank, 4 in one process), and BN
  over the deep layers' 2×2 maps amplifies that rounding; the ranks
  bit-identical;
* ``DeviceDataset`` on the card equals the host ``collate``, bit for bit;
* ``all_reduce_sum`` on card tensors: the sum forward and the summed
  gradient backward, on each of two ranks.
"""

import numpy as np
import pytest
import torch
import torch_dist_ranks

from yolojax_torch.data.dataset import Dataset, collate
from yolojax_torch.data.device_cache import KEYS, DeviceDataset
from yolojax_torch.parallel.collectives import run_ranks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the collectives and the dataset on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_two_ranks_on_one_card_match_one_process(cuda_device):
    ranks = run_ranks(torch_dist_ranks.cuda_step, 2, 4)
    got = ranks[0]
    one = got["one"]
    for k, want in one["metrics"][0].items():
        rtol = 2e-4 if k == "grad_norm" else 1e-5
        assert abs(got["metrics"][0][k] - want) <= rtol * abs(want), (k, got["metrics"], want)
    assert one["change"] < 2e-2 and one["state"] < 1e-5, one
    assert ranks[1]["metrics"] == got["metrics"] and ranks[1]["digest"] == got["digest"]


@pytest.mark.cuda
def test_device_dataset_on_the_card_equals_collate(cuda_device):
    rng = np.random.default_rng(1)
    records = [{"path": f"img{i}", "yx_min": np.full((2, 2), 0.1 * i, np.float32),
                "yx_max": np.full((2, 2), 0.5 + 0.04 * i, np.float32),
                "cls": np.asarray([i % 3, 1], np.int32), "difficult": np.zeros(2, bool)}
               for i in range(9)]
    images = {r["path"]: rng.integers(0, 256, (40 + i, 52, 3), dtype=np.uint8)
              for i, r in enumerate(records)}
    ds = Dataset(records, canvas=64, max_boxes=4, imread=images.__getitem__)
    dd = DeviceDataset(ds, cuda_device, batch_size=3, seed=4)
    idx = [8, 0, 3, 3, 11]
    got = dd.gather(idx)
    want = collate([ds.load(min(i, 8)) for i in idx])
    for k in KEYS:
        assert got[k].is_cuda and got[k].dtype == torch.from_numpy(want[k]).dtype, k
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k], err_msg=k)


@pytest.mark.cuda
def test_all_reduce_sum_on_card_tensors(cuda_device):
    for r, (value, grad) in enumerate(run_ranks(torch_dist_ranks.reduce_on_card, 2)):
        np.testing.assert_array_equal(value, [3.0, 6.0, 9.0])      # (1 + 2) · [1, 2, 3]
        np.testing.assert_array_equal(grad, [3.0, 3.0, 3.0])       # 1 + 2 from the two ranks
