"""Parity of the port's hybrid family (``repro_torch.models.hybrid``,
hymba) with the JAX package on the CPU at SMOKE size, and of the site
trees, plans and cost-model sweeps of the moe, ssm and hybrid configs.

The same numpy inputs and the same JAX-initialised parameters (converted by
``bridge``, the ReBranch cores replaced by seeded non-zero values) go
through ``repro`` and ``repro_torch`` (``device="cpu"``).  The smoke config
has ``sliding_window=8``: prompts of 11 tokens fill its SWA rings past the
window, and the decode steps wrap them again.

Tolerances and why:
  * one block (attention + SSM in parallel, per-path norms, beta fusion,
    MLP), fed the same input and cache: 1e-5 of the absmax (float code
    summed in another order; every trunk is exact).
  * whole-model logits: 5e-2 of the absmax, as ``test_torch_lm.py`` states.
  * site trees, plans and the priced sweep records: equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import deploy as jdeploy
from repro import plan as jplan
from repro.models import hybrid as jhybrid
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import plan as tplan
from repro_torch.models import hybrid as thybrid

from test_torch_lm import LOGITS_REL, _close, with_cores

NEW_ARCHS = ("granite_moe_3b", "qwen2_moe_a2_7b", "falcon_mamba_7b",
             "hymba_1_5b")


@pytest.fixture(scope="module")
def cells():
    jcfg, tcfg = jconfigs.get_smoke("hymba_1_5b"), \
        tconfigs.get_smoke("hymba_1_5b")
    assert tcfg.sliding_window == 8
    jm = jdeploy.compile_model(jcfg, plan=jplan.solve(jcfg, None,
                                                      engine="pallas_fused"))
    tm = tdeploy.compile_model(tcfg, plan=tplan.solve(tcfg, None,
                                                      engine="pallas_fused"))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    return jm, tm, with_cores(params, np.random.default_rng(1))


@pytest.mark.parametrize("layer_idx", [0, 1])    # global, then SWA
def test_hybrid_block_prefill_then_decode_vs_jax(cells, layer_idx):
    jm, tm, params = cells
    p = params["layers"][layer_idx]
    tp = bridge.to_torch(p, "cpu")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    jc = jhybrid.init_cache(jm.cfg, 2, 16, jnp.float32)["layers"][layer_idx]
    tc = thybrid.init_cache(tm.cfg, 2, 16, torch.float32,
                            "cpu")["layers"][layer_idx]
    assert tc["attn"]["k"].shape[1] == (16 if layer_idx == 0 else 8)
    wy, jc = jhybrid._block_apply(p, x, jm.cfg, layer_idx, cache=jc)
    gy = thybrid._block_apply(tp, torch.from_numpy(x), tm.cfg, layer_idx,
                              cache=tc)
    _close(gy, wy)
    for _ in range(3):
        xt = rng.normal(size=(2, 1, 64)).astype(np.float32)
        wy, jc = jhybrid._block_apply(p, xt, jm.cfg, layer_idx, cache=jc,
                                      decode=True)
        gy = thybrid._block_apply(tp, torch.from_numpy(xt), tm.cfg,
                                  layer_idx, cache=tc, decode=True)
        _close(gy, wy)
        for path in ("attn", "ssm"):
            for key, leaf in tc[path].items():
                _close(leaf, jc[path][key])


def test_hymba_forward_prefill_decode_vs_jax(cells):
    jm, tm, params = cells
    tp = bridge.to_torch(params, "cpu")
    mine = tm.init(seed=0, device="cpu")
    assert isinstance(mine["layers"], list)
    assert {k: tuple(v.shape) for k, v in bridge.flatten(mine).items()} == \
        {k: v.shape for k, v in bridge.flatten(params).items()}
    tok = np.random.default_rng(3).integers(0, 128, size=(2, 11)
                                            ).astype(np.int32)
    _close(tm.forward(tp, {"tokens": torch.from_numpy(tok)}),
           jm.forward(params, {"tokens": tok}), LOGITS_REL)
    jc = jm.init_cache(2, 16, dtype=jnp.float32)
    tc = tm.init_cache(2, 16, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in bridge.flatten(tc).items()} == \
        {k: v.shape for k, v in bridge.flatten(jc).items()}
    jl, jc = jm.prefill(params, {"tokens": tok}, jc)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, tc)
    _close(tl, jl, LOGITS_REL)
    nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for _ in range(4):                   # positions 11-14 wrap the rings
        jl, jc = jm.decode_step(params, nt, jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nt), tc)
        _close(tl, jl, LOGITS_REL)
        np.testing.assert_array_equal(tl.numpy()[:, -1].argmax(-1),
                                      np.asarray(jl)[:, -1].argmax(-1))
        nt = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    for a, b in zip(bridge.flatten(tc).values(),
                    bridge.flatten(jax.tree.map(np.asarray, jc)).values()):
        _close(a, b, LOGITS_REL)


def _strip(rec):
    out = {k: v for k, v in rec.items() if k != "plan"}
    out["entries"] = [(a, s.enabled, s.trunk_impl)
                      for a, s in rec["plan"].entries]
    return out


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_site_trees_plans_and_sweeps_equal_the_references(arch, full):
    jcfg = (jconfigs.get if full else jconfigs.get_smoke)(arch)
    tcfg = (tconfigs.get if full else tconfigs.get_smoke)(arch)

    def sites(tree):
        return [(s.name, s.kind, s.weights, s.macs, s.count, s.shape,
                 s.members, s.branch_members) for s in tree]

    assert sites(tplan.site_tree(tcfg)) == sites(jplan.site_tree(jcfg))
    jp_, tp_ = jplan.solve(jcfg, None), tplan.solve(tcfg, None)
    assert [(a, s.enabled) for a, s in tp_.entries] == \
        [(a, s.enabled) for a, s in jp_.entries]
    assert dataclasses.asdict(tp_.stats(tcfg)) == \
        dataclasses.asdict(jp_.stats(jcfg))
    for kw in ({}, {"engine": "pallas_fused", "reload_factor": 3.0}):
        assert [_strip(r) for r in tplan.sweep(tcfg, 5, **kw)] == \
            [_strip(r) for r in jplan.sweep(jcfg, 5, **kw)]
    # the port builds the config's parameter and cache trees, leaf for
    # leaf the reference's shapes and dtypes (fake tensors: no memory)
    from repro.models import api as japi
    from repro_torch.models import api as tapi

    def shapes(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in bridge.flatten(tree).items()}

    gen = torch.Generator()
    assert shapes(bridge.abstract(tapi.init, gen, tcfg)) == shapes(
        jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jcfg)))
    assert shapes(bridge.abstract(tapi.init_cache, tcfg, 2, 64,
                                  torch.float32)) == shapes(jax.eval_shape(
                                      lambda: japi.init_cache(
                                          jcfg, 2, 64, jnp.float32)))


@pytest.mark.parametrize("arch", ["hymba_1_5b", "granite_moe_3b"])
def test_bridge_crosses_list_and_stacked_expert_trees(arch):
    # hymba's per-layer list and granite's stacked [L, E, ...] expert
    # leaves cross both ways, bfloat16 included, under the JAX checkpoint
    # manager's leaf names
    from repro.checkpoint.manager import _flatten as jax_flatten
    from repro.models import api as japi
    jcfg = jconfigs.get_smoke(arch)
    params = japi.init(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a), params)
    tp = bridge.to_torch(params, "cpu")
    jflat = jax_flatten(params)
    tflat = bridge.flatten(tp)
    assert list(tflat) == list(jflat)
    assert any(t.dtype == torch.bfloat16 for t in tflat.values())
    back = bridge.to_numpy(tp)
    for k, v in bridge.flatten(back).items():
        np.testing.assert_array_equal(v, np.asarray(jflat[k], v.dtype))
    if arch == "hymba_1_5b":
        assert isinstance(tp["layers"], list)
    else:
        assert tp["layers"]["moe"]["experts"]["gate"]["rom"]["w_q"].shape \
            == (jcfg.num_layers, jcfg.num_experts, jcfg.d_model,
                jcfg.moe_d_ff)
