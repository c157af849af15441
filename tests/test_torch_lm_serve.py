"""The port's LM serving front door on the CPU: ``LMServer`` over the dense
and the paged pool, held to its own invariants and to the JAX package's
``LMServer`` on the same parameters.

Invariants: each request's tokens equal a solo ``prefill`` +
``decode_step`` run of its prompt; paged serving gives the same tokens as
dense; occupancy never exceeds the pool; admission is FIFO; no block leaks
after ``drain``.  The JAX package's own logits-bitwise batched-vs-solo
test fails on this environment (ROADMAP Queue 3) and is not used as an
oracle: the tokens are compared instead, and the first step's logits
against the JAX server's within 5e-2 of their absmax (ulp-level
differences upstream of per-row quantisers, see ``test_torch_lm.py``).
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
from repro.serve import pool as jpool
from repro.serve import registry as jregistry
from repro.serve import server as jserver
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch import deploy as tdeploy
from repro_torch import plan as tplan
from repro_torch.serve import pool as tpool
from repro_torch.serve import registry, server
from repro_torch.serve.scheduler import ContinuousBatcher

MODEL_ID = "gemma-2b-smoke"
MAX_LEN = 48
N_NEW = 6


def with_cores(tree, rng):
    if isinstance(tree, dict):
        out = {k: with_cores(v, rng) for k, v in tree.items()}
        sram = out.get("sram")
        if isinstance(sram, dict) and "core" in sram:
            sram["core"] = (rng.normal(size=sram["core"].shape) * 0.3
                            ).astype(np.float32)
        return out
    return tree


@pytest.fixture(scope="module")
def cell():
    """JAX-drawn parameters with non-zero cores, as numpy."""
    jmodel, _ = jregistry.compile_entry(MODEL_ID)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return with_cores(params, np.random.default_rng(1))


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=3 + (5 * i) % 17) for i in range(n)]


def _solo(model, params, prompt, n_new):
    cache = model.init_cache(1, MAX_LEN, dtype=torch.float32, device="cpu")
    logits, cache = model.prefill(
        params, {"tokens": torch.as_tensor(prompt[None])}, cache)
    out = [int(logits[0, -1].argmax())]
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(
            params, torch.tensor([[out[-1]]]), cache)
        out.append(int(logits[0, -1].argmax()))
    return out


def _serve(params, paged, prompts, n_slots=3, **kw):
    srv = server.load(MODEL_ID, params=bridge.to_torch(params, "cpu"),
                      n_slots=n_slots, max_len=MAX_LEN, paged=paged, **kw)
    reqs = [srv.submit(p, N_NEW) for p in prompts]
    occupancy = []
    while srv.step():
        occupancy.append(srv.pool.occupancy)
    return srv, reqs, occupancy


@pytest.mark.parametrize("paged", [False, True])
def test_tokens_equal_solo_and_invariants(cell, paged):
    prompts = _prompts(7)
    srv, reqs, occupancy = _serve(cell, paged, prompts)
    assert type(srv.pool) is (tpool.PagedPool if paged else tpool.SlotPool)
    assert max(occupancy) == srv.pool.n_slots == 3
    assert all(o <= srv.pool.n_slots for o in occupancy)
    admits = [r.admit_step for r in reqs]
    assert admits == sorted(admits)                       # FIFO
    for req, prompt in zip(reqs, prompts):
        assert req.done and len(req.tokens) == N_NEW
        assert req.tokens == _solo(srv.model, srv.params, prompt, N_NEW)
    assert srv.pool.occupancy == 0 and srv.batcher.idle
    if paged:
        assert srv.pool.blocks_in_use == 0 == srv.pool.blocks_reserved
        assert len(srv.pool._free_blocks) == srv.pool.n_blocks
        assert (srv.pool._table == srv.pool._trash).all()


@pytest.mark.parametrize("paged", [False, True])
def test_batched_decode_logits_equal_solo_bitwise(cell, paged):
    """One decode step over three adopted rows gives each row the logits
    of its own solo decode step, bit for bit (the batch-variant GEMMs and
    reductions run on bucketed rows, ``repro_torch/core/rows.py``)."""
    model, _ = registry.compile_entry(MODEL_ID)
    params = bridge.to_torch(cell, "cpu")
    pool = (tpool.PagedPool(model, 3, 18, 8, MAX_LEN, device="cpu")
            if paged else tpool.SlotPool(model, 3, MAX_LEN, device="cpu"))
    prompts, solo = _prompts(3, seed=9), []
    for row, prompt in enumerate(prompts):
        assert pool.try_admit(prompt.size + 2) == row
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(prompt[None])},
            pool.solo_cache())
        pool.adopt(row, cache)                 # copies; cache stays solo
        tok = int(logits[0, -1].argmax())
        solo.append((tok, model.decode_step(params, torch.tensor([[tok]]),
                                            cache)[0]))
    pool.prepare_step()
    toks = torch.tensor([[t] for t, _ in solo])
    batched, _ = model.decode_step(params, toks, pool.cache)
    for row, (_, want) in enumerate(solo):
        assert torch.equal(batched[row], want[0])


def test_paged_equals_dense_and_the_jax_server(cell):
    prompts = _prompts(6, seed=3)
    _, dense, _ = _serve(cell, False, prompts)
    _, paged, _ = _serve(cell, True, prompts, block_size=8)
    assert [r.tokens for r in paged] == [r.tokens for r in dense]
    jsrv = jserver.load(MODEL_ID, params=jax.tree.map(jnp.asarray, cell),
                        n_slots=3, max_len=MAX_LEN, prefill_chunk=0)
    jreqs = [jsrv.submit(p, N_NEW) for p in prompts]
    jsrv.drain()
    assert [r.tokens for r in paged] == [r.tokens for r in jreqs]
    # the first step's logits, on the same prompt
    jmodel, _ = jregistry.compile_entry(MODEL_ID)
    jl, _ = jmodel.prefill(cell, {"tokens": prompts[0][None]},
                           jmodel.init_cache(1, MAX_LEN, dtype=jnp.float32))
    tmodel, _ = registry.compile_entry(MODEL_ID)
    tl, _ = tmodel.prefill(
        bridge.to_torch(cell, "cpu"),
        {"tokens": torch.as_tensor(prompts[0][None])},
        tmodel.init_cache(1, MAX_LEN, dtype=torch.float32, device="cpu"))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=5e-2 * np.abs(jl).max())


def test_paged_admission_waits_for_blocks_and_late_joins(cell):
    """Six blocks of 8 hold two 24-position requests, not three: the third
    waits for blocks (not rows), then joins a running batch."""
    prompts = _prompts(3, seed=5)
    srv = server.load(MODEL_ID, params=bridge.to_torch(cell, "cpu"),
                      n_slots=3, max_len=MAX_LEN, paged=True, n_blocks=6,
                      block_size=8)
    reqs = [srv.submit(p[:10], 14) for p in prompts]
    srv.step()
    assert srv.batcher.active == 2 and srv.batcher.queued == 1
    assert srv.pool.free_slots == 1
    srv.drain(max_steps=100)
    assert reqs[2].admit_step > reqs[0].admit_step
    for req, prompt in zip(reqs, prompts):
        assert req.tokens == _solo(srv.model, srv.params, prompt[:10], 14)
    assert srv.pool.blocks_in_use == 0


def test_eos_retires_early(cell):
    prompt = _prompts(1, seed=7)[0]
    full = _solo(registry.compile_entry(MODEL_ID)[0],
                 bridge.to_torch(cell, "cpu"), prompt, N_NEW)
    srv = server.load(MODEL_ID, params=bridge.to_torch(cell, "cpu"),
                      n_slots=2, max_len=MAX_LEN)
    req = srv.submit(prompt, N_NEW, eos_id=full[1])
    srv.drain(max_steps=20)
    assert req.tokens == full[:2]


def test_load_sizes_the_pool_like_the_jax_package():
    """``load`` without ``n_slots`` sizes the pool from the plan's SRAM
    residency (paged: twice the dense rows in the same bytes)."""
    srv = server.load(MODEL_ID, device="cpu", max_len=64)
    jsrv = jserver.load(MODEL_ID, max_len=64)
    assert (srv.pool.n_rows, srv.pool.n_blocks, srv.pool.block_size) == \
        (jsrv.pool.n_rows, jsrv.pool.n_blocks, jsrv.pool.block_size)
    dense = server.load(MODEL_ID, device="cpu", max_len=64, paged=False)
    assert dense.pool.n_slots == \
        jserver.load(MODEL_ID, max_len=64, paged=False).pool.n_slots
    assert tpool.cache_bytes_per_slot(srv.model, 64) == \
        jpool.cache_bytes_per_slot(jsrv.model, 64)


def test_full_gemma_gets_one_dense_slot():
    """At full width the branch cores alone exceed the 64 MB SRAM budget,
    so the plan leaves room for one slot (the JAX package says the same)."""
    tcfg, jcfg = tconfigs.get("gemma_2b"), jconfigs.get("gemma_2b")
    tplan_, jplan_ = tplan.solve(tcfg), jplan.solve(jcfg)
    tm = tdeploy.compile_model(tcfg, plan=tplan_)
    jm = jdeploy.compile_model(jcfg, plan=jplan_)
    assert tpool.cache_bytes_per_slot(tm, 256) == \
        jpool.cache_bytes_per_slot(jm, 256)
    assert tpool.suggest_slots(tm, tplan_, 256) == \
        jpool.suggest_slots(jm, jplan_, 256) == 1
    assert tpool.suggest_paged(tm, tplan_, 256) == \
        jpool.suggest_paged(jm, jplan_, 256)


def test_front_door_validation_and_unported_options(cell):
    srv = server.load(MODEL_ID, params=bridge.to_torch(cell, "cpu"),
                      n_slots=2, max_len=16)
    with pytest.raises(ValueError, match="empty prompt"):
        srv.submit([], 3)
    with pytest.raises(ValueError, match="max_new_tokens"):
        srv.submit([1, 2], 0)
    with pytest.raises(ValueError, match="max_len=16"):
        srv.submit(np.arange(10), 7)
    with pytest.raises(ValueError, match="no ScenarioStore"):
        srv.swap_scenario("night")
    # speculative decode and chunked prefill are ported: what they refuse
    # is the reference's (a negative k; a config whose cache cannot roll
    # back or whose prefill cannot continue a cache)
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        ContinuousBatcher(srv.model, srv.params, srv.pool, spec_k=-1)
    swa = types.SimpleNamespace(cfg=dataclasses.replace(
        srv.model.cfg, sliding_window=8))
    with pytest.raises(ValueError, match="cannot speculate"):
        ContinuousBatcher(swa, srv.params, srv.pool, spec_k=2)
    ssm = types.SimpleNamespace(cfg=dataclasses.replace(
        srv.model.cfg, family="ssm"))
    with pytest.raises(ValueError, match="cannot chunk prefill"):
        ContinuousBatcher(ssm, srv.params, srv.pool, prefill_chunk=32)
    assert ContinuousBatcher(srv.model, srv.params, srv.pool, spec_k=2,
                             prefill_chunk=32).spec_k == 2
    with pytest.raises(ValueError, match="double-released"):
        srv.pool.release(0)
    with pytest.raises(ValueError, match="does not divide"):
        tpool.PagedPool(srv.model, 2, 8, 5, 16)


def test_registry_serves_every_dense_smoke_id():
    ids = {i for i in jregistry.registered_ids() if i.endswith("-smoke")}
    dense = {a.replace("_", "-") + "-smoke" for a in tconfigs.DENSE_ARCHS}
    assert dense <= ids and dense <= set(registry.registered_ids())
    srv = server.load("qwen15-32b-smoke", device="cpu", n_slots=2,
                      max_len=16)          # QKV bias, MHA-style KV
    req = srv.submit([3, 1, 4, 1, 5], 4)
    srv.drain(max_steps=10)
    assert len(req.tokens) == 4 and all(0 <= t < 128 for t in req.tokens)
