"""Port parity, train-mode blocks: ``yolojax_torch.models.blocks.conv_apply``
and ``max_pool`` against ``yolojax.models.blocks`` on the same numpy inputs
(CPU; JAX NHWC/HWIO, the port NCHW/OIHW).

Each case compares the block's output, its new BN state and the gradients
of ``Σ y·cot`` (a seeded cotangent) with respect to every parameter and the
input.  Tolerances: f32 rtol 1e-4 with atol 1e-5 of the largest magnitude;
bf16 outputs within one bf16 ulp of the largest magnitude (2⁻⁷ relative)
and its gradients within 2 % of theirs (the two libraries' convolutions sum
in other orders before the bf16 roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.models import blocks as jblocks
from yolojax_torch.models import blocks

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": (1e-4, 1e-5, 1e-5), "bf16": (0.0, 2.0 ** -7, 2e-2)}   # rtol, out atol, grad atol


def nchw(a):
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def init(rng, cin, cout, k, use_bn, groups=1):
    w = rng.normal(0, np.sqrt(2.0 / (k * k * cin // groups)), (k, k, cin // groups, cout))
    params = {"w": w.astype(np.float32)}
    state = {}
    if use_bn:
        params["gamma"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
        params["beta"] = rng.normal(0, 0.2, cout).astype(np.float32)
        state = {"mean": rng.normal(0, 0.1, cout).astype(np.float32),
                 "var": rng.uniform(0.8, 1.2, cout).astype(np.float32)}
    else:
        params["b"] = rng.normal(0, 0.2, cout).astype(np.float32)
    return params, state


def port_params(params):
    return {n: torch.from_numpy(v.transpose(3, 2, 0, 1).copy() if n == "w" else v)
            for n, v in params.items()}


def close(got, want, dtype, scale_atol):
    rtol, atol, _ = TOL[dtype]
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=scale_atol * max(np.abs(want).max(), 1e-6))


CASES = {
    "bn": dict(bn=True), "bn-stride2": dict(bn=True, stride=2),
    "bn-no-gamma": dict(bn=True, cfg=dict(gamma=False)),
    "bn-no-beta": dict(bn=True, cfg=dict(beta=False)),
    "bn-neither": dict(bn=True, cfg=dict(gamma=False, beta=False)),
    "bn-disabled": dict(bn=True, cfg=dict(enable=False)),
    "bias-linear": dict(bn=False, act=False, k=1),
    "depthwise": dict(bn=True, groups=6),
    "eval-mode": dict(bn=True, train=False),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv_apply_matches(rng, case, dtype):
    spec = CASES[case]
    k, stride, groups = spec.get("k", 3), spec.get("stride", 1), spec.get("groups", 1)
    act, train = spec.get("act", True), spec.get("train", True)
    cin, cout = 6, 6 if groups > 1 else 8
    jdt, tdt = DTYPES[dtype]
    params, state = init(rng, cin, cout, k, spec["bn"], groups)
    x = rng.uniform(-1, 1, (2, 7, 7, cin)).astype(np.float32)
    cfg = dict(momentum=0.03, **spec.get("cfg", {}))
    kw = dict(stride=stride, groups=groups, act=act, train=train)

    def jfn(p, xx):
        y, ns = jblocks.conv_apply(p, state, xx, bn=jblocks.BNConfig(**cfg), compute_dtype=jdt,
                                   **kw)
        return y, ns

    want_y, want_state = jfn(params, jnp.asarray(x))
    cot = rng.normal(0, 1, want_y.shape).astype(np.float32)
    jgrads = jax.grad(lambda p, xx: jnp.sum(jfn(p, xx)[0].astype(jnp.float32) * cot),
                      argnums=(0, 1))(params, jnp.asarray(x))

    tp = {n: v.requires_grad_(True) for n, v in port_params(params).items()}
    tx = torch.from_numpy(nchw(x)).requires_grad_(True)
    tstate = {n: torch.from_numpy(v) for n, v in state.items()}
    y, new_state = blocks.conv_apply(tp, tstate, tx, bn=blocks.BNConfig(**cfg),
                                     compute_dtype=tdt, **kw)
    assert y.dtype == tdt
    (y.float() * torch.from_numpy(nchw(cot))).sum().backward()

    close(y.detach().float().numpy(), nchw(want_y), dtype, TOL[dtype][1])
    assert new_state.keys() == dict(want_state).keys()
    for n in new_state:
        assert not new_state[n].requires_grad and new_state[n].dtype == torch.float32
        close(new_state[n].numpy(), want_state[n], dtype, TOL[dtype][1])
    for n, g in jgrads[0].items():
        got = tp[n].grad
        got = np.zeros(tp[n].shape, np.float32) if got is None else got.numpy()
        want = np.asarray(g, np.float32)
        if n == "w":
            want = want.transpose(3, 2, 0, 1)
        close(got, want, dtype, TOL[dtype][2])
    close(tx.grad.float().numpy(), nchw(jgrads[1]), dtype, TOL[dtype][2])


def test_train_state_uses_the_biased_variance(rng):
    params, state = init(rng, 3, 4, 3, True)
    x = rng.uniform(-1, 1, (2, 5, 5, 3)).astype(np.float32)
    tstate = {n: torch.from_numpy(v) for n, v in state.items()}
    bn = blocks.BNConfig(momentum=1.0)
    y, new_state = blocks.conv_apply(port_params(params), tstate, torch.from_numpy(nchw(x)),
                                     act=False, bn=bn, train=True, compute_dtype=torch.float32)
    raw = blocks.conv(torch.from_numpy(nchw(x)), port_params(params)["w"])
    torch.testing.assert_close(new_state["var"], raw.var(dim=(0, 2, 3), unbiased=False))
    torch.testing.assert_close(new_state["mean"], raw.mean(dim=(0, 2, 3)))


def test_leaky_gradient_at_zero_is_one():
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    blocks.leaky_relu(x).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jblocks.leaky_relu(v)))(jnp.asarray([-1.0, 0.0, 2.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    assert x.grad[1] == 1.0


@pytest.mark.parametrize("size,stride", [(2, 2), (2, 1), (3, 2)])
def test_max_pool_gradient_routes_ties_to_the_first_maximum(rng, size, stride):
    # few distinct values: most windows hold ties, and with -1s, the SAME
    # pool's -inf border never wins
    x = rng.integers(-1, 2, (2, 6, 6, 3)).astype(np.float32)
    want_y = jblocks.max_pool(jnp.asarray(x), size, stride)
    cot = rng.normal(0, 1, want_y.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jblocks.max_pool(v, size, stride) * cot))(jnp.asarray(x))
    tx = torch.from_numpy(nchw(x)).requires_grad_(True)
    y = blocks.max_pool(tx, size, stride)
    np.testing.assert_array_equal(y.detach().numpy(), nchw(want_y))
    (y * torch.from_numpy(nchw(cot))).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), nchw(want))
