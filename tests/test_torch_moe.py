"""Parity of the port's MoE block (``repro_torch.models.moe``) and the moe
family with the JAX package, on the CPU at SMOKE size.

The same numpy inputs and the same JAX-initialised parameters (converted by
``bridge``, the ReBranch cores replaced by seeded non-zero values) go
through ``repro`` and ``repro_torch`` (``device="cpu"``).

Tolerances and why:
  * the stacked expert trunk is exact in both (int32 accumulation in the
    reference, f32 products on K-chunks whose partial sums stay below
    2**24 in the port): bitwise.
  * an expert linear's float branch GEMMs sum in another order: 1e-5 of
    the absmax.
  * the MoE block: the routing (router GEMM, softmax, top-k, capacity
    slots) gives the same assignments; the combine adds a token's k kept
    choices in ascending expert order where the reference's one-hot einsum
    sums over (expert, slot): 1e-5 of the absmax.
  * whole-model logits: 5e-2 of the absmax, as ``test_torch_lm.py`` states
    (an ulp upstream of a per-row int8 quantiser can move an int8 code).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import deploy as jdeploy
from repro import plan as jplan
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import plan as tplan
from repro_torch.models import moe as tmoe

from test_torch_lm import LOGITS_REL, _close, with_cores

MOE_ARCHS = ("granite_moe_3b", "qwen2_moe_a2_7b")


def _block_params(arch, seed=0, **overrides):
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **overrides)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), **overrides)
    p = jax.tree.map(np.asarray,
                     jmoe.init_moe_block(jax.random.PRNGKey(seed), jcfg))
    return jcfg, tcfg, with_cores(p, np.random.default_rng(seed + 1))


def test_int8_bmm_is_exact_where_one_f32_accumulation_is_not():
    # +-127 codes at K = 1536: the row sums pass 2**24, so one running f32
    # sum over K (a GEMM's inner loop) rounds; K-chunks of at most 1040
    # keep every partial sum exact
    rng = np.random.default_rng(0)
    k = 1536
    x = np.full((2, 3, k), 127, np.int8)
    x[:, 1, ::5] = -127
    w = rng.choice(np.array([127, 125, 123, 121], np.int8), size=(2, k, 16))
    exact = np.einsum("eck,ekn->ecn", x.astype(np.int64),
                      w.astype(np.int64))
    assert np.abs(exact).max() > 2 ** 24
    assert 127 * 127 * tmoe.EXACT_K < 2 ** 24
    got = tmoe.int8_bmm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    running = np.cumsum(x[..., :, None].astype(np.float32)
                        * w[:, None].astype(np.float32), axis=2,
                        dtype=np.float32)[:, :, -1]
    assert (running != exact.astype(np.float32)).any()
    # the reference's int32 dot_general agrees bit for bit
    want = jax.lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32).astype(jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d_in,d_out", [(64, 48), (1100, 24)])
def test_apply_expert_linear_vs_jax(d_in, d_out):
    spec = tconfigs.get_smoke("granite_moe_3b").rebranch
    jspec = jconfigs.get_smoke("granite_moe_3b").rebranch
    p = jax.tree.map(np.asarray, jmoe.init_expert_linear(
        jax.random.PRNGKey(3), 4, d_in, d_out, jspec))
    p = with_cores(p, np.random.default_rng(4))
    x = np.random.default_rng(5).normal(size=(4, 6, d_in)).astype(np.float32)
    x[1, 2] = 0.0                       # an empty capacity slot
    tp, tx = bridge.to_torch(p, "cpu"), torch.from_numpy(x)
    # the trunk, bitwise
    got = tmoe.stacked_trunk_matmul(tx, tp["rom"]["w_q"], tp["rom"]["w_scale"])
    want = jmoe._stacked_trunk_matmul(x, p["rom"]["w_q"], p["rom"]["w_scale"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(tmoe.apply_expert_linear(tp, tx),
           jmoe.apply_expert_linear(p, x))
    # the port's init draws the reference's tree, shape for shape
    mine = tmoe.init_expert_linear(torch.Generator().manual_seed(0), 4,
                                   d_in, d_out, spec)
    assert {k: tuple(v.shape) for k, v in bridge.flatten(mine).items()} == \
        {k: v.shape for k, v in bridge.flatten(p).items()}


def test_stacked_trunk_grad_is_ste():
    # tests/test_moe.py::test_stacked_trunk_grad_is_ste, on the port
    spec = jconfigs.get_smoke("granite_moe_3b").rebranch
    p = jax.tree.map(np.asarray, jmoe.init_expert_linear(
        jax.random.PRNGKey(0), 3, 16, 8, spec))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, 4, 16)))
    tx = torch.from_numpy(x).requires_grad_(True)
    tp = bridge.to_torch(p, "cpu")
    tmoe.stacked_trunk_matmul(tx, tp["rom"]["w_q"],
                              tp["rom"]["w_scale"]).sum().backward()
    w_deq = (np.asarray(p["rom"]["w_q"], np.float32)
             * np.asarray(p["rom"]["w_scale"], np.float32))
    want = np.einsum("ecf,edf->ecd", np.ones((3, 4, 8), np.float32), w_deq)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-4, atol=1e-4)
    jdx = jax.grad(lambda a: jnp.sum(jmoe._stacked_trunk_matmul(
        a, p["rom"]["w_q"], p["rom"]["w_scale"])))(x)
    _close(tx.grad, jdx)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_block_vs_jax(arch):
    # granite: routed experts only; qwen2-moe: plus the gated shared ones
    jcfg, tcfg, p = _block_params(arch)
    assert ("shared" in p) == bool(jcfg.num_shared_experts)
    x = np.random.default_rng(6).normal(size=(2, 9, 64)).astype(np.float32)
    got = tmoe.apply_moe_block(bridge.to_torch(p, "cpu"),
                               torch.from_numpy(x), tcfg)
    _close(got, jmoe.apply_moe_block(p, x, jcfg))
    # the aux loss is the same function
    _close(tmoe.aux_load_balance_loss(bridge.to_torch(p, "cpu"),
                                      torch.from_numpy(x), tcfg),
           jmoe.aux_load_balance_loss(p, x, jcfg))


def _jax_dispatch(p, x, jcfg, monkeypatch):
    """The reference's dispatch tensor [G, g, E, C] of one
    ``apply_moe_block`` call, taken from its dispatch einsum."""
    seen = {}

    def einsum(spec, *args, **kw):
        if spec == "gtec,gtd->egcd":
            seen["dispatch"] = np.asarray(args[0], np.float32)
        return jnp.einsum(spec, *args, **kw)

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                     if not k.startswith("__")})
    proxy.einsum = einsum
    monkeypatch.setattr(jmoe, "jnp", proxy)
    y = jmoe.apply_moe_block(p, x, jcfg)
    monkeypatch.undo()
    return seen["dispatch"], y


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_drops_are_the_references(arch, monkeypatch):
    # a small capacity factor and more tokens than a group: choices are
    # dropped, the last group is padded, and the pad tokens' tied
    # probabilities pick the lowest experts in both packages
    jcfg, tcfg, p = _block_params(arch, seed=2, moe_capacity_factor=0.3)
    x = np.random.default_rng(7).normal(size=(3, 15, 64)).astype(np.float32)
    dispatch, want = _jax_dispatch(p, x, jcfg, monkeypatch)
    tp, tx = bridge.to_torch(p, "cpu"), torch.from_numpy(x)
    g = min(tcfg.moe_group_size, 45)
    xf = torch.nn.functional.pad(tx.reshape(45, 64), (0, 0, 0, 2 * g - 45))
    idx, _, slot, keep = tmoe.route(tp, xf.reshape(2, g, 64), tcfg)
    assert not keep.all() and keep.any()
    mine = np.zeros_like(dispatch)
    gi, ti, ji = np.nonzero(keep.numpy())
    mine[gi, ti, idx.numpy()[gi, ti, ji], slot.numpy()[gi, ti, ji]] = 1.0
    np.testing.assert_array_equal(mine, dispatch)
    _close(tmoe.apply_moe_block(tp, tx, tcfg), want)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def cells(request):
    arch = request.param
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    jm = jdeploy.compile_model(jcfg, plan=jplan.solve(jcfg, None,
                                                      engine="pallas_fused"))
    tm = tdeploy.compile_model(tcfg, plan=tplan.solve(tcfg, None,
                                                      engine="pallas_fused"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = with_cores(params, np.random.default_rng(1))
    return jm, tm, params


def test_moe_model_forward_prefill_decode_vs_jax(cells):
    jm, tm, params = cells
    tp = bridge.to_torch(params, "cpu")
    mine = tm.init(seed=0, device="cpu")
    assert {k: tuple(v.shape) for k, v in bridge.flatten(mine).items()} == \
        {k: v.shape for k, v in bridge.flatten(params).items()}
    tok = np.random.default_rng(3).integers(
        0, jm.cfg.vocab_size, size=(2, 11)).astype(np.int32)
    _close(tm.forward(tp, {"tokens": torch.from_numpy(tok)}),
           jm.forward(params, {"tokens": tok}), LOGITS_REL)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    tc = tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    jl, jc = jm.prefill(params, {"tokens": tok}, jc)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, tc)
    _close(tl, jl, LOGITS_REL)
    nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(3):
        jl, jc = jm.decode_step(params, nt, jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nt), tc)
        _close(tl, jl, LOGITS_REL)
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1),
                                      np.asarray(jl)[:, -1].argmax(-1))
        nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
