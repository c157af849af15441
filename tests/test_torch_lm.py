"""Parity of the port's LM layers, transformer and LM deploy surface with
the JAX package, on the CPU.

The same numpy inputs and parameters (drawn by the JAX package, the ReBranch
cores replaced by seeded non-zero values) go through both packages.

Tolerances and why:
  * rmsnorm, RoPE and attention are float code that the two frameworks sum
    and evaluate in another order (mean, rsqrt, cos/sin, softmax): 1e-5 of
    the absmax.  The embedding lookup is bitwise.
  * every ReBranch linear of a layer, fed the same input, keeps its trunk
    bitwise (the int8 dots are exact and the scales round identically);
    its float branch GEMMs are held to 1e-5 of the absmax.
  * whole-model logits are held to 5e-2 of the absmax: the ulp-level
    differences above sit upstream of per-row int8 quantisers, and an ulp
    that moves a row across a rounding boundary moves its int8 code, and
    with it the row's output by up to a quantisation step (measured: 6.0e-3
    of the absmax for gemma-2b-smoke under int8_native, 2e-7 under
    pallas_fused where no code moved).  The greedy token is asserted too.
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
from repro.checkpoint.manager import _flatten as jax_flatten
from repro.core import quant as jquant
from repro.core import rebranch as jrebranch
from repro.kernels.rebranch_conv import trunk_conv_pallas
from repro.models import layers as jlayers
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import plan as tplan
from repro_torch.core import quant as tquant
from repro_torch.core import rebranch as trebranch
from repro_torch.kernels import rebranch_matmul as trm
from repro_torch.models import layers as tlayers

REL = 1e-5          # float code: of the absmax
LOGITS_REL = 5e-2   # whole forwards: of the absmax (see the docstring)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def with_cores(tree, rng):
    """Seeded N(0, 0.05) ReBranch cores, so every branch contributes."""
    if isinstance(tree, dict):
        out = {k: with_cores(v, rng) for k, v in tree.items()}
        sram = out.get("sram")
        if isinstance(sram, dict) and "core" in sram:
            sram["core"] = (rng.normal(size=sram["core"].shape) * 0.05
                            ).astype(np.float32)
        return out
    return tree


def _cells(cfg_name, engine, **overrides):
    jcfg = dataclasses.replace(jconfigs.get_smoke(cfg_name), **overrides)
    tcfg = dataclasses.replace(tconfigs.get_smoke(cfg_name), **overrides)
    jm = jdeploy.compile_model(jcfg, plan=jplan.solve(jcfg, None,
                                                      engine=engine))
    tm = tdeploy.compile_model(tcfg, plan=tplan.solve(tcfg, None,
                                                      engine=engine))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    params = with_cores(params, np.random.default_rng(1))
    return jm, tm, params


@pytest.fixture(scope="module")
def gemma():
    return _cells("gemma_2b", "int8_native")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_vs_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    p = {"sram": {"scale": rng.normal(size=(64,)).astype(np.float32)}}
    want = jlayers.apply_rmsnorm(p, x, 1e-6)
    got = tlayers.apply_rmsnorm(bridge.to_torch(p, "cpu"),
                                torch.from_numpy(x), 1e-6)
    _close(got, want)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_vs_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 4, 32)).astype(np.float32)
    pos = np.array([np.arange(7), np.arange(7) + 40, np.arange(7) + 200],
                   np.int32)
    want = jlayers.apply_rope(x, pos, theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    _close(got, want)
    # the frequencies are the reference's float64 numpy, cast to f32
    np.testing.assert_array_equal(tlayers.rope_frequencies(32, theta),
                                  jlayers.rope_frequencies(32, theta))


def test_embedding_and_tied_readout_vs_jax(gemma):
    jm, tm, params = gemma
    emb = params["embed"]
    tok = np.random.default_rng(2).integers(0, 512, size=(2, 9))
    want = jlayers.apply_embedding(emb, tok, jm.cfg)
    got = tlayers.apply_embedding(bridge.to_torch(emb, "cpu"),
                                  torch.from_numpy(tok), tm.cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.random.default_rng(3).normal(size=(2, 1, 64)).astype(np.float32)
    _close(tlayers.embedding_as_logits(bridge.to_torch(emb, "cpu"),
                                       torch.from_numpy(x), tm.cfg),
           jlayers.embedding_as_logits(emb, x, jm.cfg))
    # the table quantiser (per-token scale, division form) is bitwise
    table = np.random.default_rng(4).normal(size=(50, 64)).astype(np.float32)
    jq, js = jquant.quantize_weights(table, axis=1)
    tq, ts = tquant.quantize_weights(torch.from_numpy(table), axis=1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("window,offset", [(0, 0), (5, 0), (0, 6)])
def test_chunked_causal_attention_vs_jax(window, offset):
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 7, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 13, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 13, 2, 16)).astype(np.float32)
    want = jlayers._chunked_causal_attention(q, k, v, 4, window,
                                             kv_offset=offset)
    got = tlayers._chunked_causal_attention(
        *map(torch.from_numpy, (q, k, v)), 4, window, kv_offset=offset)
    _close(got, want)


def test_decode_attention_and_paged_gather_vs_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 12, 2, 16)).astype(np.float32)
    valid = np.array([1, 7, 12], np.int32)
    want = jlayers._decode_attention(q, kc, vc, valid)
    got = tlayers._decode_attention(*map(torch.from_numpy,
                                         (q, kc, vc, valid)))
    _close(got, want)
    leaf = rng.normal(size=(7, 4, 2, 16)).astype(np.float32)
    table = np.array([[3, 0, 6], [6, 6, 6], [1, 2, 5]], np.int32)
    np.testing.assert_array_equal(
        tlayers._gather_paged(torch.from_numpy(leaf),
                              torch.from_numpy(table)).numpy(),
        np.asarray(jlayers._gather_paged(leaf, table)))


def _attn_params(params):
    return jax.tree.map(lambda a: a[0], params["layers"]["attn"])


def test_apply_attention_prefill_and_decode_vs_jax(gemma):
    """Prefill into a dense cache, then decode against it and against the
    same rows laid out in a paged cache: outputs and caches vs JAX."""
    jm, tm, params = gemma
    cfg_j, cfg_t = jm.cfg, tm.cfg
    p = _attn_params(params)
    pt = bridge.to_torch(p, "cpu")
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 6, 64)).astype(np.float32)
    jc = jlayers.init_attention_cache(cfg_j, 1, 16, 0, jnp.float32)
    tc = tlayers.init_attention_cache(cfg_t, 1, 16, 0, torch.float32)
    jo, jc = jlayers.apply_attention(p, x, cfg_j, 0, cache=jc)
    to, tc = tlayers.apply_attention(pt, torch.from_numpy(x), cfg_t, 0,
                                     cache=tc)
    _close(to, jo)
    _close(tc["k"], jc["k"])
    assert tc["length"].tolist() == [6]

    # decode one token on the JAX cache state, dense and paged
    xd = rng.normal(size=(1, 1, 64)).astype(np.float32)
    jcache = jax.tree.map(np.asarray, jc)
    jo2, jc2 = jlayers.apply_attention(p, xd, cfg_j, 0,
                                       cache=jax.tree.map(jnp.asarray, jc),
                                       decode=True)
    dense = bridge.to_torch(jcache, "cpu")
    to2, tc2 = tlayers.apply_attention(pt, torch.from_numpy(xd), cfg_t, 0,
                                       cache=dense, decode=True)
    _close(to2, jo2)
    _close(tc2["k"], jc2["k"])
    assert tc2["length"].tolist() == [7]
    paged = tlayers.init_paged_attention_cache(cfg_t, 2, 5, 4, 16,
                                               torch.float32)
    paged["table"][0] = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    for key in ("k", "v"):
        paged[key][[2, 0, 3, 1]] = torch.as_tensor(
            jcache[key][0].reshape(4, 4, 1, 32))
    paged["length"][0] = 6
    dense2 = tlayers.init_attention_cache(cfg_t, 2, 16, 0, torch.float32)
    for key in ("k", "v", "length"):
        dense2[key][0] = torch.as_tensor(jcache[key][0])
    xp = torch.from_numpy(np.concatenate([xd, xd]))
    tp2, pc = tlayers.apply_attention(pt, xp, cfg_t, 0, cache=paged,
                                      decode=True)
    td2, _ = tlayers.apply_attention(pt, xp, cfg_t, 0, cache=dense2,
                                     decode=True)
    assert torch.equal(tp2, td2)              # paging moves bytes, not bits
    _close(tp2[:1], jo2)
    assert pc["length"].tolist() == [7, 1]


@pytest.mark.parametrize("mlp_type", ["geglu", "swiglu"])
def test_apply_mlp_vs_jax(mlp_type):
    jm, tm, params = _cells("gemma_2b", "pallas_fused", mlp_type=mlp_type)
    p = jax.tree.map(lambda a: a[0], params["layers"]["mlp"])
    x = np.random.default_rng(8).normal(size=(2, 3, 64)).astype(np.float32)
    _close(tlayers.apply_mlp(bridge.to_torch(p, "cpu"), torch.from_numpy(x),
                             tm.cfg),
           jlayers.apply_mlp(p, x, jm.cfg))


# ---------------------------------------------------------------------------
# the whole model, linear by linear
# ---------------------------------------------------------------------------

def _trunks(engine, rom, x):
    """(port trunk, JAX trunk) of one ROM site on the same input."""
    x2 = x.reshape(-1, x.shape[-1])
    w_q = rom["w_q"]
    if engine == "pallas_fused":
        got, _ = trm.rebranch_trunk_sketch(torch.from_numpy(x2),
                                           torch.from_numpy(w_q),
                                           torch.from_numpy(rom["C"]))
        ones = np.ones((w_q.shape[1],), np.float32)
        want = trunk_conv_pallas(x2[:, None, None, :], w_q[None, None], ones,
                                 jrebranch.ReBranchSpec().cim)[:, 0, 0]
        return got.numpy(), np.asarray(want)
    got = trebranch.trunk_matmul(trebranch.ReBranchSpec().cim,
                                 torch.from_numpy(x), *map(
                                     torch.from_numpy, (w_q, rom["w_scale"])))
    want = jrebranch.trunk_matmul(jrebranch.ReBranchSpec().cim, None, x, w_q,
                                  rom["w_scale"])
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("engine,d_ff", [("int8_native", 256),
                                         ("pallas_fused", 256),
                                         ("pallas_fused", 1280)])
def test_model_prefill_decode_linear_by_linear_vs_jax(engine, d_ff,
                                                      monkeypatch):
    """Gemma-2B smoke (and a d_ff=1280 variant whose ``down`` spans three
    k-blocks): prefill + one decode step.  Every ReBranch linear the port
    runs is re-run by the JAX package on the same input."""
    jm, tm, params = _cells("gemma_2b", engine, d_ff=d_ff)
    tp = bridge.to_torch(params, "cpu")
    calls = []
    apply_linear = trebranch.apply_linear

    def recording(p, x, spec):
        y = apply_linear(p, x, spec)
        calls.append((bridge.to_numpy(p), x.numpy().copy(), y.numpy()))
        return y

    monkeypatch.setattr(trebranch, "apply_linear", recording)
    tok = np.random.default_rng(9).integers(0, 512, size=(1, 11))
    tc = tm.init_cache(1, 32, dtype=torch.float32, device="cpu")
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tok)}, tc)
    nxt = np.array([[int(tl[0, -1].argmax())]])
    tl2, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc)
    assert len(calls) == 2 * 2 * 7          # 2 passes x 2 layers x 7 linears
    for p, x, y in calls:
        _close(y, jrebranch.apply_linear(p, x, jm.cfg.rebranch))
        got, want = _trunks(engine, p["rom"], x)
        np.testing.assert_array_equal(got, want)
    monkeypatch.undo()

    jc = jm.init_cache(1, 32, dtype=jnp.float32)
    jl, jc = jm.prefill(params, {"tokens": tok.astype(np.int32)}, jc)
    jl2, jc = jm.decode_step(params, nxt.astype(np.int32), jc)
    _close(tl, jl, LOGITS_REL)
    _close(tl2, jl2, LOGITS_REL)
    assert int(np.argmax(jl[0, -1])) == nxt[0, 0]
    # the features path (no cache) agrees with the prefill's last row
    x = tm.features(tp, {"tokens": torch.from_numpy(tok)})
    _close(tm.apply_head(tp, x[:, -1:]), tl, LOGITS_REL)


# ---------------------------------------------------------------------------
# trees, plans and the deploy surface
# ---------------------------------------------------------------------------

def test_params_and_caches_line_up_key_for_key(gemma):
    jm, tm, params = gemma
    tparams = tm.init(seed=0, device="cpu")
    want = {k: (v.shape, v.dtype.name) for k, v in
            jax_flatten(params).items()}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[1])
           for k, v in bridge.flatten(tparams).items()}
    assert list(got) == list(want)
    assert got == want
    assert bridge.flatten(bridge.to_torch(params, "cpu")).keys() == \
        got.keys()
    # bfloat16 leaves (the JAX cache default) cross exactly
    kv = jnp.asarray(np.random.default_rng(11).normal(size=(2, 3, 4, 1, 32)),
                     jnp.bfloat16)
    tkv = bridge.to_torch({"k": np.asarray(kv)}, "cpu")["k"]
    assert tkv.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy({"k": tkv})["k"],
                                  np.asarray(kv, np.float32))
    for build in ("dense", "paged"):
        if build == "dense":
            jc = jm.init_cache(3, 16, dtype=jnp.float32)
            tc = tm.init_cache(3, 16, dtype=torch.float32, device="cpu")
        else:
            jc = jm.init_paged_cache(3, 9, 4, 16, dtype=jnp.float32)
            tc = tm.init_paged_cache(3, 9, 4, 16, dtype=torch.float32,
                                     device="cpu")
        jflat = {k: np.asarray(v) for k, v in jax_flatten(jc).items()}
        tflat = bridge.flatten(bridge.to_numpy(tc))
        assert list(tflat) == list(jflat)
        for k, v in jflat.items():
            np.testing.assert_array_equal(tflat[k], v, err_msg=k)


def _site_fields(site):
    return (site.name, site.kind, site.weights, site.macs, site.count,
            tuple(site.shape), tuple(site.members))


def _spec_fields(spec):
    return (spec.enabled, spec.trunk_impl, spec.branch_enabled, spec.d_ratio,
            spec.u_ratio, dataclasses.astuple(spec.cim))


@pytest.mark.parametrize("name", ["gemma_2b", "yi_34b", "qwen15_32b",
                                  "deepseek_67b"])
@pytest.mark.parametrize("full", [True, False])
def test_site_trees_and_plans_match_jax(name, full):
    jcfg = (jconfigs.get if full else jconfigs.get_smoke)(name)
    tcfg = (tconfigs.get if full else tconfigs.get_smoke)(name)
    assert [_site_fields(s) for s in tplan.site_tree(tcfg)] == \
        [_site_fields(s) for s in jplan.site_tree(jcfg)]
    for budget in (None, 1e9):
        jp = jplan.solve(jcfg, budget, engine="pallas_fused")
        tp = tplan.solve(tcfg, budget, engine="pallas_fused")
        assert [(a, _spec_fields(s)) for a, s in tp.entries] == \
            [(a, _spec_fields(s)) for a, s in jp.entries]
        assert _spec_fields(tp.default) == _spec_fields(jp.default)
        js, ts = jp.stats(jcfg), tp.stats(tcfg)
        assert dataclasses.astuple(ts) == tuple(
            getattr(js, f.name) for f in dataclasses.fields(ts))


def test_deploy_geometry_errors(gemma):
    _, tm, params = gemma
    tp = bridge.to_torch(params, "cpu")
    cache = tm.init_cache(2, 8, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="batch=2 but tokens have batch=1"):
        tm.prefill(tp, {"tokens": torch.zeros((1, 3), dtype=torch.long)},
                   cache)
    with pytest.raises(ValueError, match="ONE token per sequence"):
        tm.decode_step(tp, torch.zeros((2, 2), dtype=torch.long), cache)
    with pytest.raises(ValueError, match="exceeds the cache horizon 8"):
        tm.prefill(tp, {"tokens": torch.zeros((2, 9), dtype=torch.long)},
                   cache)
    paged = tm.init_paged_cache(2, 5, 4, 8, dtype=torch.float32,
                                device="cpu")
    with pytest.raises(ValueError, match="PagedPool.adopt"):
        tm.prefill(tp, {"tokens": torch.zeros((2, 3), dtype=torch.long)},
                   paged)
    with pytest.raises(ValueError, match="block-table rows 2"):
        tm.decode_step(tp, torch.zeros((3, 1), dtype=torch.long), paged)
    with pytest.raises(ValueError, match="does not divide"):
        tm.init_paged_cache(2, 5, 3, 8, device="cpu")


def test_unported_families_and_branches_raise(tmp_path):
    """The multi-device item has come: the checkpoints' ``shardings=``
    (elastic restore) reads the checkpoint (here: none yet, so it says
    so), and the train CLI's ``--compress`` trains (one process: nothing
    to all-reduce).  What still raises names ROADMAP: an ssm LM on a mesh
    (tensor parallelism beyond the dense and moe families, item 5(d)).  The vlm
    (M-RoPE) and audio (codebooks)
    branches are ported: configs using them now build."""
    from repro_torch.checkpoint import manager as tckpt
    from repro_torch.launch import train as ttrain
    from repro_torch.launch import mesh as tmesh
    tcfg = tconfigs.get_smoke("gemma_2b")
    tm = tdeploy.compile_model(tcfg)
    tp = tm.init(seed=0, device="cpu")
    t, _ = trebranch.partition(tp)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tckpt.restore(str(tmp_path), t, {}, tp, shardings=(None, None))
    losses = ttrain.main(["--smoke", "--compress", "--steps", "2", "--batch",
                          "2", "--seq", "8"], device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdeploy.compile_model(tconfigs.get_smoke("falcon_mamba_7b"),
                              mesh=tmesh.AbstractMesh((2, 2)))
    for kw in (dict(mrope=True), dict(num_codebooks=2)):
        cfg = dataclasses.replace(tcfg, **kw)
        params = tdeploy.compile_model(cfg).init(seed=0, device="cpu")
        assert ("codebook_head" in params) == bool(cfg.num_codebooks)
    # the moe family is ported: its site tree enumerates
    moe = tconfigs.get_smoke("granite_moe_3b")
    assert [s.name for s in tplan.site_tree(moe)] == ["blocks.attn",
                                                      "blocks.moe"]
