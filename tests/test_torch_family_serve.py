"""The moe, ssm and hybrid families served through the port's ``LMServer``
on the CPU, held to solo decode and to the JAX package's server on the same
parameters (kernels 3 and 4 at these families' new linear geometries are
held on the card by ``tests/test_torch_gpu.py``).

falcon-mamba (ssm) and hymba (hybrid) serve over the dense ``SlotPool``
(``paged=None`` follows ``api.supports_paging``) with whole-prompt
prefill: every request's tokens equal its solo decode and the JAX
server's.  granite-moe and qwen2-moe serve over the paged pool with
chunked prefill, the JAX server's defaults too, and their tokens equal the
JAX server's: batched == solo is not the MoE contract, because the rows of
one decode step compete for expert capacity slots in the reference's
dispatch (shown below, in both packages).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.serve import registry as jregistry
from repro.serve import server as jserver
from repro_torch import bridge
from repro_torch import configs as tconfigs
from repro_torch.models import api
from repro_torch.models import moe as tmoe
from repro_torch.serve import pool as tpool
from repro_torch.serve import registry, server
from repro_torch.serve.scheduler import ContinuousBatcher

from test_torch_lm_serve import with_cores

MAX_LEN = 48
N_NEW = 6
RECURRENT = ("falcon-mamba-7b-smoke", "hymba-1-5b-smoke")
MOE = ("granite-moe-3b-smoke", "qwen2-moe-a2-7b-smoke")


def _params(model_id):
    jmodel, _ = jregistry.compile_entry(model_id)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return with_cores(params, np.random.default_rng(1))


def _prompts(n, seed=0, longest=17):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 128, size=3 + (5 * i) % longest)
            for i in range(n)]


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


def _jax_tokens(model_id, params, prompts, n_slots):
    jsrv = jserver.load(model_id, params=jax.tree.map(jnp.asarray, params),
                        n_slots=n_slots, max_len=MAX_LEN)
    reqs = [jsrv.submit(p, N_NEW) for p in prompts]
    jsrv.drain()
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("model_id", RECURRENT)
def test_recurrent_families_serve_as_solo_and_as_jax(model_id):
    params = _params(model_id)
    prompts = _prompts(5, seed=2)
    srv = server.load(model_id, params=bridge.to_torch(params, "cpu"),
                      n_slots=3, max_len=MAX_LEN)
    assert type(srv.pool) is tpool.SlotPool
    assert srv.batcher.prefill_chunk == 0
    reqs = [srv.submit(p, N_NEW) for p in prompts]
    occupancy = []
    while srv.step():
        occupancy.append(srv.pool.occupancy)
    assert max(occupancy) == 3 and srv.pool.occupancy == 0
    for req, prompt in zip(reqs, prompts):
        assert req.tokens == _solo(srv.model, srv.params, prompt, N_NEW)
    assert [r.tokens for r in reqs] == _jax_tokens(model_id, params,
                                                   prompts, 3)


@pytest.mark.parametrize("model_id", MOE)
def test_moe_families_serve_as_jax(model_id):
    params = _params(model_id)
    prompts = _prompts(5, seed=4, longest=40)      # 38 > one 32-token chunk
    srv = server.load(model_id, params=bridge.to_torch(params, "cpu"),
                      n_slots=3, max_len=MAX_LEN)
    assert type(srv.pool) is tpool.PagedPool
    assert srv.batcher.prefill_chunk == 32
    reqs = [srv.submit(p, N_NEW) for p in prompts]
    srv.drain(max_steps=100)
    assert srv.pool.blocks_in_use == 0
    assert [r.tokens for r in reqs] == _jax_tokens(model_id, params,
                                                   prompts, 3)


@pytest.mark.parametrize("model_id", RECURRENT)
def test_recurrent_families_refuse_spec_chunks_and_paging(model_id):
    model, _ = registry.compile_entry(model_id)
    params = model.init(seed=0, device="cpu")
    cfg = model.cfg
    assert not (api.supports_paging(cfg) or api.supports_speculation(cfg)
                or api.supports_chunked_prefill(cfg))
    pool = tpool.SlotPool(model, 1, 32, device="cpu")
    assert ContinuousBatcher(model, params, pool).prefill_chunk == 0
    with pytest.raises(ValueError, match="cannot chunk"):
        ContinuousBatcher(model, params, pool, prefill_chunk=8)
    with pytest.raises(ValueError, match="spec_k=0"):
        ContinuousBatcher(model, params, pool, spec_k=2)
    with pytest.raises(ValueError, match="speculative verify"):
        model.verify_step(params, torch.zeros((1, 2), dtype=torch.long),
                          model.init_cache(1, 32, dtype=torch.float32,
                                           device="cpu"))
    with pytest.raises(ValueError, match="cannot page its KV cache"):
        server.LMServer(model, params, n_slots=2, max_len=32, paged=True)
    with pytest.raises(ValueError, match="cannot serve through a paged KV"):
        tpool.PagedPool(model, 2, 8, 8, 32, device="cpu")


@pytest.mark.parametrize("arch,horizon_none", [("falcon_mamba_7b", True),
                                               ("hymba_1_5b", False),
                                               ("qwen2_moe_a2_7b", False)])
def test_cache_geometry_all_families(arch, horizon_none):
    # tests/test_serve.py::test_geometry_helper_all_families, on the port
    cfg = tconfigs.get_smoke(arch)
    cache = api.init_cache(cfg, 3, 16, torch.float32, "cpu")
    batch, horizon = api.cache_geometry(cfg, cache)
    assert batch == 3 and (horizon is None) == horizon_none
    if horizon is not None:
        assert horizon == 16
    jcfg = jconfigs.get_smoke(arch)
    assert (batch, horizon) == japi.cache_geometry(
        jcfg, japi.init_cache(jcfg, 3, 16, jnp.float32))
    # and the per-slot bytes the pools are sized by
    model, _ = registry.compile_entry(arch.replace("_", "-") + "-smoke")
    jmodel, _ = jregistry.compile_entry(arch.replace("_", "-") + "-smoke")
    from repro.serve import pool as jpool
    assert tpool.cache_bytes_per_slot(model, 64) == \
        jpool.cache_bytes_per_slot(jmodel, 64)


def test_registry_serves_every_ported_family():
    ids = {a.replace("_", "-") + "-smoke" for a in tconfigs.PORTED_ARCHS}
    assert ids <= set(registry.registered_ids())
    assert ids <= set(jregistry.registered_ids())


def test_a_free_rows_token_can_change_a_live_rows_moe_output():
    """A fault of the reference that the port mirrors (ROADMAP Queue 3):
    at a decode step every pool row routes, free rows too, and a dropped
    choice still counts against its expert, so the hidden states of the
    free rows can take a capacity slot that a live row's second choice
    needed.  16 rows (capacity 12): rows 0-3 live, rows 4-15 free."""
    jcfg = jconfigs.get_smoke("granite_moe_3b")
    tcfg = tconfigs.get_smoke("granite_moe_3b")
    p = jax.tree.map(np.asarray,
                     jmoe.init_moe_block(jax.random.PRNGKey(0), jcfg))
    tp = bridge.to_torch(p, "cpu")
    rng = np.random.default_rng(5)
    live = rng.normal(size=(4, 64)).astype(np.float32)
    idx, _, _, _ = tmoe.route(tp, torch.from_numpy(live)[None], tcfg)
    second = int(idx[0, 0, 1])           # live row 0's second choice
    cands = rng.normal(size=(400, 64)).astype(np.float32)
    top1 = tmoe.route(tp, torch.from_numpy(cands)[None], tcfg)[0][0, :, 0]
    steal = cands[int(np.nonzero(top1.numpy() == second)[0][0])]
    other = cands[int(np.nonzero(top1.numpy() != second)[0][0])]
    outs = {}
    for name, free in (("steal", steal), ("other", other)):
        x = np.concatenate([live, np.repeat(free[None], 12, 0)])[:, None]
        outs[name] = (np.asarray(jmoe.apply_moe_block(p, x, jcfg))[0],
                      tmoe.apply_moe_block(tp, torch.from_numpy(x),
                                           tcfg).numpy()[0])
    for i in range(2):                   # the reference, then the port
        assert not np.allclose(outs["steal"][i], outs["other"][i],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(outs["steal"][1], outs["steal"][0],
                               rtol=0, atol=1e-5)
