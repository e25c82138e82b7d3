"""Port parity: the pool and reorg kernels' fused modes, the engine's routing
into them, and the repaired caps of nms_select and dwsep.

On the CPU each wrapper runs its plain version; it is held against the JAX
package: the conv epilogue ``_post_conv`` (folded params: f32 ``+ b``,
leaky, cast back) then ``maxpool2x2_pallas``, or ``reorg_pallas`` then
``jnp.concatenate``, the Pallas kernels in interpret mode as
tests/test_kernels.py runs them.  Tolerances: exact (the epilogue is one f32
add, one f32 multiply and one rounding on both sides; a max and a layout
shuffle are exact).  The Darknet-s2d and Tiny plans run full width at 64² in
f32 through the fused routing: bit-identical to the port's own unrouted
forward, and within the JAX engine's raw head at rtol/atol 1e-3
(test_torch_mobilenet.py's bound: convolutions summed in other orders).  On
the card the kernels are held to their plain versions in
``tests/test_torch_cuda_nms_pool_reorg.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import yolojax.kernels.pool as jpool
import yolojax.kernels.reorg as jreorg
import yolojax.models as jmodels
from yolojax.models.darknet import Darknet as JDarknet
from yolojax.models.darknet import Tiny as JTiny
from yolojax.models.engine import _post_conv
from yolojax_torch.kernels import dwconv as dk
from yolojax_torch.kernels import dwsep as sk
from yolojax_torch.kernels import nms as nk
from yolojax_torch.kernels import pool as pk
from yolojax_torch.kernels import reorg as rk
from yolojax_torch.models import LayerDef
from yolojax_torch.models import engine
from yolojax_torch.models.darknet import Darknet, Tiny
from yolojax_torch.utils.checkpoint import from_jax

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# an H100's opt-in shared memory per block less nms_select's static part
H100_SMEM = 232448 - 140


@pytest.fixture(autouse=True)
def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _jax_epilogue(x, b, act, dtype):
    y, _ = _post_conv({"b": jnp.asarray(b)}, {}, jnp.asarray(x, dtype), bn=None, act=act,
                      compute_dtype=dtype)
    return y


# -- the fused modes against the JAX package ---------------------------------

@pytest.mark.parametrize("shape", [(1, 64, 64, 16), (2, 16, 16, 128), (2, 2, 2, 72)])
@pytest.mark.parametrize("act,full", [(True, False), (True, True), (False, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_pool_matches_jax_epilogue_and_pallas_pool(rng, shape, act, full, dtype):
    tdt, jdt = DTYPES[dtype]
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.normal(0, 0.5, shape[-1]).astype(np.float32)
    y = _jax_epilogue(x, b, act, jdt)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpool.maxpool2x2_pallas(y), np.float32)
    before = pk.maxpool2x2.launches
    got = pk.maxpool2x2(torch.from_numpy(x).to(tdt), torch.from_numpy(b), act, full)
    assert pk.maxpool2x2.launches == before
    if full:
        got, got_full = got
        assert got_full.dtype == tdt and got_full.shape == shape and got_full.is_contiguous()
        np.testing.assert_array_equal(got_full.float().numpy(), np.asarray(y, np.float32))
    assert got.dtype == tdt and got.is_contiguous()
    assert got.shape == want.shape == (shape[0], shape[1] // 2, shape[2] // 2, shape[3])
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shape,ct", [((2, 8, 8, 64), 32), ((1, 64, 64, 8), 16),
                                      ((2, 4, 6, 3), 5)])
@pytest.mark.parametrize("bias,act,tail", [(True, True, True), (True, False, True),
                                           (True, True, False), (False, True, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_reorg_concat_matches_jax_epilogue_pallas_reorg_and_concat(rng, shape, ct, bias,
                                                                         act, tail, dtype):
    tdt, jdt = DTYPES[dtype]
    n, h, w, c = shape
    x = rng.standard_normal(shape).astype(np.float32)
    b = rng.normal(0, 0.5, c).astype(np.float32)
    t = rng.standard_normal((n, h // 2, w // 2, ct)).astype(np.float32)
    y = _jax_epilogue(x, b, act, jdt) if bias else jnp.asarray(x, jdt)
    with pltpu.force_tpu_interpret_mode():
        want = jreorg.reorg_pallas(y, 2)
    if tail:
        want = jnp.concatenate([want, jnp.asarray(t, jdt)], axis=-1)
    got = rk.reorg_s2d(torch.from_numpy(x).to(tdt), 2,
                       torch.from_numpy(t).to(tdt) if tail else None,
                       torch.from_numpy(b) if bias else None, act)
    assert got.dtype == tdt
    assert got.shape == want.shape == (n, h // 2, w // 2, 4 * c + (ct if tail else 0))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_fused_modes_check_their_extra_arguments():
    x = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match="needs a bias"):
        pk.maxpool2x2(x, None, True, True)
    with pytest.raises(ValueError, match="bias"):
        pk._check(x, torch.zeros(4))                        # C = 8
    with pytest.raises(ValueError, match="bias"):
        rk._check(x, 2, None, torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="tail"):
        rk._check(x, 2, torch.zeros((1, 2, 3, 5)))          # W/s = 2
    with pytest.raises(ValueError, match="tail"):
        rk._check(x, 2, torch.zeros((1, 2, 2, 5), dtype=torch.bfloat16))
    pk._check(x, torch.zeros(8))
    rk._check(x, 2, torch.zeros((1, 2, 2, 5)), torch.zeros(8))


# -- the routed plans ---------------------------------------------------------

def _randomize_bn(rng, params, state):
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    for name in state:
        shape = state[name]["mean"].shape
        state[name]["mean"] = rng.normal(0, 0.2, shape).astype(np.float32)
        state[name]["var"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        params[name]["gamma"] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        params[name]["beta"] = rng.normal(0, 0.1, shape).astype(np.float32)
    return params, state


def _spy(monkeypatch, module, name, log):
    """Log (kernel, x shape, the other arguments with tensors as their shapes)
    per call."""
    fn = getattr(module, name)

    def spy(x, *args):
        shapes = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args)
        log.append((name, tuple(x.shape), shapes))
        return fn(x, *args)

    monkeypatch.setattr(module, name, spy)


# (the JAX model, the port's model class, its tokens, the routed calls at 64²:
# (kernel, input shape, the other arguments with tensors as their shapes))
PLANS = {
    "darknet-s2d": (
        lambda anchors, tokens: JDarknet(anchors=anchors, num_classes=4, dtype=jnp.float32,
                                         reorg_order="s2d", pallas=tokens),
        lambda anchors, tokens: Darknet(anchors=anchors, num_classes=4, dtype=torch.float32,
                                        reorg_order="s2d", pallas=tokens),
        frozenset({"nms", "pool", "reorg"}),
        [("maxpool2x2", (2, 16, 16, 128), ((128,), True, False)),       # c5, pool3
         ("maxpool2x2", (2, 8, 8, 256), ((256,), True, False)),         # c8, pool4
         ("maxpool2x2", (2, 4, 4, 512), ((512,), True, True)),          # c13, s16, pool5
         ("reorg_s2d", (2, 4, 4, 64), (2, (2, 2, 2, 1024), (64,), True))]),  # c21, concat top
    "tiny": (
        lambda anchors, tokens: JTiny(anchors=anchors, num_classes=4, dtype=jnp.float32,
                                      pallas=tokens),
        lambda anchors, tokens: Tiny(anchors=anchors, num_classes=4, dtype=torch.float32,
                                     pallas=tokens),
        frozenset({"nms", "fusedpost", "pool"}),
        [("maxpool2x2", (2, 8, 8, 128), ((128,), True, False)),         # c4, pool4
         ("maxpool2x2", (2, 4, 4, 256), ((256,), True, False))]),       # c5, pool5
}


@pytest.mark.parametrize("name", list(PLANS))
def test_routed_plan_fuses_the_epilogues_and_matches_the_jax_engine(rng, monkeypatch, name):
    jax_model, port_model, tokens, calls = PLANS[name]
    seed = np.random.default_rng(17)
    anchors = seed.uniform(0.5, 3.0, (5, 2)).astype(np.float32)
    jmodel = jax_model(anchors, tokens)
    params, state = _randomize_bn(seed, *jmodel.init(jax.random.PRNGKey(7)))
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    monkeypatch.setattr(jmodels, "pallas_active", lambda which, enabled: which in enabled)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmodel.apply_folded(jmodel.fold(params, state), jnp.asarray(x)))

    log = []
    _spy(monkeypatch, pk, "maxpool2x2", log)
    _spy(monkeypatch, rk, "reorg_s2d", log)
    model = port_model(anchors, tokens)
    folded = model.fold(*from_jax(params, state))
    with torch.no_grad():
        got = model.apply_folded(folded, torch.from_numpy(x))
        assert log == calls
        unrouted = dataclasses.replace(model, pallas=frozenset()).apply_folded(
            folded, torch.from_numpy(x))
    assert len(log) == len(calls)                 # the unrouted forward calls no kernel
    assert torch.equal(got, unrouted)
    assert got.shape == want.shape == (2, 2, 2, 45)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)


def test_a_marked_conv_before_a_routed_pool_fills_its_slot_with_the_epilogue(rng):
    """conv, mark, pool, load: the slot holds the conv block's output."""
    d = LayerDef("c", 128, 3)
    engine.resolve_in_channels([("conv", d)], 8)
    w = torch.from_numpy(rng.standard_normal((128, 8, 3, 3)).astype(np.float32) * 0.2)
    folded = {"c": {"w": w, "b": torch.from_numpy(rng.normal(0, 0.5, 128).astype(np.float32))}}
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 8)).astype(np.float32))
    for tail, shape in ((["pool"], (2, 3, 3, 128)), (["pool", "load"], (2, 6, 6, 128))):
        plan = [("conv", d), ("mark", "s"), ("pool", 2, 2)] + [("load", "s")] * (len(tail) - 1)
        got = engine.run_plan(plan, folded, x, compute_dtype=torch.float32,
                              pallas=frozenset({"pool"}))
        want = engine.run_plan(plan, folded, x, compute_dtype=torch.float32)
        assert got.shape == shape
        assert torch.equal(got, want)


# -- the repaired caps --------------------------------------------------------

@pytest.mark.parametrize("n", [845, 1805, 2205, 3645, 9600])
def test_nms_select_takes_every_candidate_count_the_card_holds(n):
    """Sizes 416, 608, 672 and 864 give N = 845, 1805, 2205 and 3645; the
    last two need more than the 48 KB a block gets without opting in."""
    nk.check_candidates(n, H100_SMEM)
    assert (nk.smem_bytes(n) > 48 * 1024) == (n > 2048)


def test_nms_select_raises_only_above_the_cards_limit():
    with pytest.raises(ValueError, match=f"over the card's {H100_SMEM}"):
        nk.check_candidates(9700, H100_SMEM)


def test_nms_select_reads_the_limit_once_per_device(monkeypatch):
    import ctypes

    queries = []

    def query(t, address):
        queries.append(t.get_device())
        ctypes.c_int.from_address(address).value = 1000 + t.get_device()

    class Device:
        def __init__(self, index):
            self.index = index

        def get_device(self):
            return self.index

    monkeypatch.setattr(nk, "_SMEM_QUERY", query)
    monkeypatch.setattr(nk, "_SMEM_LIMITS", {})
    assert [nk.smem_limit(Device(i)) for i in (0, 1, 0, 1, 0)] == [1000, 1001, 1000, 1001, 1000]
    assert queries == [0, 1]


def _pair(c):
    dw = LayerDef("dw", c, 3, groups=-1)
    pw = LayerDef("pw", 64, 1)
    plan = [("conv", dw), ("conv", pw)]
    engine.resolve_in_channels(plan, c)
    return plan


@pytest.mark.parametrize("c,dtype,paired", [(1152, torch.bfloat16, False),
                                            (1024, torch.bfloat16, True),
                                            (1152, torch.float32, True)])
def test_dwsep_gate_keeps_wide_bf16_pairs_off_the_kernel(c, dtype, paired):
    plan = _pair(c)
    assert (engine._dwsep_pair(plan, 0, 13, dtype) is plan[1][1]) == paired


def test_a_wide_bf16_pair_takes_the_dwconv_kernel_and_computes_the_same(rng, monkeypatch):
    plan = _pair(1152)
    folded = {"dw": {"w": torch.from_numpy(rng.standard_normal((1152, 1, 3, 3)).astype(
                  np.float32) * 0.3).to(torch.bfloat16),
                     "b": torch.from_numpy(rng.normal(0, 0.5, 1152).astype(np.float32))},
              "pw": {"w": torch.from_numpy(rng.standard_normal((64, 1152, 1, 1)).astype(
                  np.float32) * 0.03).to(torch.bfloat16),
                     "b": torch.from_numpy(rng.normal(0, 0.5, 64).astype(np.float32))}}
    tokens = frozenset({"dwsep", "dwconv"})
    engine.add_kernel_weights(plan, folded, tokens)
    calls = []
    for module, name in ((dk, "dwconv3x3"), (sk, "dwsep")):
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, fn=fn, name=name: calls.append(name) or fn(*a))
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 1152)).astype(np.float32))
    got = engine.run_plan(plan, folded, x, compute_dtype=torch.bfloat16, pallas=tokens)
    assert calls == ["dwconv3x3"]
    want = engine.run_plan(plan, folded, x, compute_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2, atol=1e-2)
