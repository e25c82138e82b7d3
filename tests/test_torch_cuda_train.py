"""The port's training path on the card, against the same code on the CPU.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU.  The
file imports torch, numpy, pytest and ``yolojax_torch`` only, so it runs on
a machine without JAX (``chip_smoke.py`` runs it with the other
``tests/test_torch_cuda_*.py``):

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_cuda_*.py

TF32 is off, so f32 on the card and on the CPU differ by summation order
only.  Tolerances: the region loss rtol 1e-5 (values and gradient, atol 1e-6
of the gradient's largest magnitude); a train-mode conv block f32 rtol
1e-4 with atol 1e-5 of the largest magnitude, bf16 one bf16 ulp of it
(2⁻⁷) on the output and 2 % on the gradients; the augmentation f32 atol
5e-5, bf16 2⁻⁶ with 99.9 % within 2⁻⁷; one f32 train step of full-width
Tiny at 96², B=2: components and grad_norm rtol 2e-4, the params' change
and the BN state as ‖card − CPU‖ / ‖CPU‖ over the model within 1e-3 and
1e-5.  The overlapped loader's copies are exact.
"""

import configparser

import numpy as np
import pytest
import torch

from yolojax_torch.data.loader import overlap_device_puts
from yolojax_torch.data.transform import TrainAugment
from yolojax_torch.models import blocks
from yolojax_torch.models.darknet import Darknet, Tiny
from yolojax_torch.ops.loss import LossConfig, region_loss
from yolojax_torch.parallel.mesh import loss_weights_from_config, make_train_step
from yolojax_torch.utils.train import build_optimizer

ANCHORS = np.asarray([[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11], [16.62, 10.52]],
                     np.float32)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the training path on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def gt(rng, b, g, valid=0.7):
    center = rng.uniform(0.1, 0.9, (b, g, 2))
    half = rng.uniform(0.02, 0.3, (b, g, 2))
    return {"yx_min": torch.from_numpy(np.clip(center - half, 0, 1).astype(np.float32)),
            "yx_max": torch.from_numpy(np.clip(center + half, 0, 1).astype(np.float32)),
            "cls": torch.from_numpy(rng.integers(0, 20, (b, g)).astype(np.int32)),
            "valid": torch.from_numpy(rng.uniform(size=(b, g)) < valid)}


def train_config(**extra):
    config = configparser.ConfigParser()
    config.read_dict({"train": {"learning_rate": "1e-3", "milestones": "1", "clip": "5",
                                "sparsity": "0.01", **extra}, "loss": {}})
    return config


def tree_rel(got: dict, want: dict) -> float:
    diff = sum(float(((got[k][n].cpu().double() - v.double()) ** 2).sum())
               for k, lp in want.items() for n, v in lp.items())
    norm = sum(float((v.double() ** 2).sum()) for lp in want.values() for v in lp.values())
    return (diff / norm) ** 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("class_grad", ["darknet", "mse"])
def test_region_loss_on_the_card_matches_the_cpu(cuda_device, rng, class_grad):
    raw = torch.from_numpy(rng.normal(0, 1.5, (16, 13, 13, 125)).astype(np.float32))
    boxes = gt(rng, 16, 30)
    results = []
    for dev in ("cpu", cuda_device):
        r = raw.to(dev).detach().requires_grad_(True)
        comps = region_loss(r, torch.from_numpy(ANCHORS).to(dev), boxes["yx_min"].to(dev),
                            boxes["yx_max"].to(dev), boxes["cls"].to(dev),
                            boxes["valid"].to(dev), 100, LossConfig(class_grad=class_grad))
        sum(comps.values()).backward()
        results.append(({k: v.item() for k, v in comps.items()}, r.grad.cpu().numpy()))
    (want, want_grad), (got, got_grad) = results
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got_grad, want_grad, rtol=1e-5,
                               atol=1e-6 * np.abs(want_grad).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("stride,groups", [(1, 1), (2, 1), (1, 64)], ids=["s1", "s2", "dw"])
def test_train_conv_block_on_the_card_matches_the_cpu(cuda_device, rng, dtype, stride, groups):
    c = 64
    params = {"w": torch.from_numpy(rng.normal(0, 0.1, (c, c // groups, 3, 3)).astype(np.float32)),
              "gamma": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)),
              "beta": torch.from_numpy(rng.normal(0, 0.2, c).astype(np.float32))}
    state = {"mean": torch.zeros(c), "var": torch.ones(c)}
    x = torch.from_numpy(rng.uniform(-1, 1, (4, c, 26, 26)).astype(np.float32))
    results = []
    for dev in ("cpu", cuda_device):
        p = {n: v.to(dev).detach().requires_grad_(True) for n, v in params.items()}
        xx = x.to(dev).contiguous(memory_format=torch.channels_last).detach().requires_grad_(True)
        y, ns = blocks.conv_apply(p, {n: v.to(dev) for n, v in state.items()}, xx,
                                  stride=stride, groups=groups, train=True, compute_dtype=dtype)
        (y.float() * torch.linspace(-1, 1, y.numel(), device=dev).view(y.shape)).sum().backward()
        results.append([y.detach().float().cpu(), *(v.cpu() for v in ns.values()),
                        *(p[n].grad.cpu() for n in params), xx.grad.float().cpu()])
    out_atol, grad_atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0 ** -7, 2e-2)
    rtol = 1e-4 if dtype == torch.float32 else 0.0
    for i, (got, want) in enumerate(zip(results[1], results[0])):
        atol = (out_atol if i < 3 else grad_atol) * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{i}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_augment_on_the_card_matches_the_cpu(cuda_device, rng, dtype):
    aug = TrainAugment(dtype=dtype)
    b, c = 8, 224
    canvas = torch.from_numpy(rng.integers(0, 256, (b, c, c, 3), dtype=np.uint8))
    hw = torch.from_numpy(rng.integers(80, c + 1, (b, 2)).astype(np.float32))
    boxes = gt(rng, b, 10)
    draws = aug.draw(torch.Generator().manual_seed(3), b)
    cpu = aug.apply(canvas, hw, boxes["yx_min"], boxes["yx_max"], boxes["valid"], draws, 160)
    dev = aug.apply(canvas.to(cuda_device), hw.to(cuda_device), boxes["yx_min"].to(cuda_device),
                    boxes["yx_max"].to(cuda_device), boxes["valid"].to(cuda_device), draws, 160)
    img, want = dev[0].float().cpu(), cpu[0].float()
    assert dev[0].dtype == dtype and img.shape == (b, 160, 160, 3)
    diff = (img - want).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 5e-5
    else:
        assert float(diff.max()) <= 2.0 ** -6 and float((diff <= 2.0 ** -7).float().mean()) >= 0.999
    for i in (1, 2):
        torch.testing.assert_close(dev[i].cpu(), cpu[i], rtol=0, atol=1e-6)
    assert torch.equal(dev[3].cpu(), cpu[3])


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device, rng):
    model = Tiny(anchors=ANCHORS, num_classes=20, dtype=torch.float32)
    params, state = model.init(torch.Generator().manual_seed(0))
    config = train_config()
    optimizer = build_optimizer(config)
    step = make_train_step(model, optimizer, loss_weights_from_config(config), LossConfig())
    batch = {"images": torch.from_numpy(rng.uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)),
             **gt(rng, 2, 4, valid=1.0)}
    on = lambda tree, dev: {k: {n: v.to(dev) for n, v in lp.items()} for k, lp in tree.items()}
    out = {}
    for dev in ("cpu", cuda_device):
        p, s, o = on(params, dev), on(state, dev), optimizer.init(on(params, dev))
        for _ in range(2):
            p, s, o, m = step(p, s, o, {k: v.to(dev) for k, v in batch.items()}, 0)
        out[str(dev)] = (p, s, o, m)
    (cp, cs, co, cm), (gp, gs, go, gm) = out["cpu"], out[str(cuda_device)]
    for k in ("coord", "object", "noobject", "cls", "prior", "total", "grad_norm"):
        np.testing.assert_allclose(gm[k].item(), cm[k].item(), rtol=2e-4, err_msg=k)
    change = lambda tree: {k: {n: v.cpu() - params[k][n] for n, v in lp.items()}
                           for k, lp in tree.items()}
    assert tree_rel(change(gp), change(cp)) < 1e-3
    assert tree_rel(gs, cs) < 1e-5
    assert go["count"] == co["count"] == 2
    assert all(v.device.type == "cuda" for lp in gp.values() for v in lp.values())


@pytest.mark.cuda
def test_bf16_step_at_416(cuda_device, rng):
    model = Darknet(anchors=ANCHORS, num_classes=20, dtype=torch.bfloat16)
    params, state = model.init(torch.Generator().manual_seed(1), cuda_device)
    optimizer = build_optimizer(train_config())
    aug = TrainAugment()
    step = make_train_step(model, optimizer, loss_weights_from_config(train_config()),
                           LossConfig(), augment=aug)
    b = 8
    batch = {"canvas": torch.from_numpy(rng.integers(0, 256, (b, 512, 512, 3), dtype=np.uint8)),
             "hw": torch.from_numpy(rng.integers(200, 513, (b, 2)).astype(np.float32)),
             **gt(rng, b, 20)}
    batch = {k: v.to(cuda_device) for k, v in batch.items()}
    p, s, o, m = step(params, state, optimizer.init(params), batch, 0,
                      aug.draw(torch.Generator().manual_seed(2), b), 416)
    assert all(np.isfinite(m[k].item()) for k in ("coord", "object", "noobject", "cls", "prior",
                                                  "total", "grad_norm"))
    assert all(bool(torch.isfinite(g).all()) for lp in m["grads"].values() for g in lp.values())
    assert all(not torch.equal(p[k]["w"], params[k]["w"]) for k in params)
    assert all(v.dtype == torch.float32 for lp in p.values() for v in lp.values())
    assert not torch.equal(s["c1"]["mean"], state["c1"]["mean"])
    assert s["c1"]["var"].dtype == torch.float32


@pytest.mark.cuda
def test_overlap_device_puts_on_the_card(cuda_device, rng):
    batches = [{"canvas": rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
                "hw": rng.uniform(10, 64, (4, 2)).astype(np.float32)} for _ in range(6)]
    got = []
    for batch in overlap_device_puts(iter(batches), cuda_device, ("canvas", "hw")):
        assert batch["canvas"].device.type == "cuda"
        got.append({k: (v.float() * 1).cpu() for k, v in batch.items()})   # work on the stream
    assert len(got) == 6
    for g, want in zip(got, batches):
        assert np.array_equal(g["canvas"].numpy(), want["canvas"])
        assert np.array_equal(g["hw"].numpy(), want["hw"])

    def failing():
        yield batches[0]
        raise ValueError("bad record")

    it = overlap_device_puts(failing(), cuda_device)
    next(it)
    with pytest.raises(ValueError, match="bad record"):
        next(it)
