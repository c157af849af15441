"""Speculative decode in the port on the CPU: the branch-only draft, the
batched verify and the pools' rollback, held to their own invariants and
to the JAX package on the same parameters (``gemma-2b-smoke``, ``max_len``
48, JAX-drawn parameters with seeded non-zero cores).

Invariants (``docs/ARCHITECTURE.md``, "Serving invariants"): speculative
tokens equal plain greedy decode bit for bit, whatever the draft quality,
in dense and paged pools; a verify over a block equals, position by
position, the decode steps that feed the same tokens; rejected drafts
never leak blocks.  Logits are held to the JAX package's within 5e-2 of
their absmax (the LM tolerance: ulp-level differences upstream of per-row
quantisers, see ``test_torch_lm.py``); tokens exactly.

The JAX package is imported inside the fixtures, so the ``gpu`` test at
the end runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_spec.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.models import api
from repro_torch.serve import pool as tpool
from repro_torch.serve import registry, server
from repro_torch.serve.scheduler import ContinuousBatcher

MODEL_ID = "gemma-2b-smoke"
MAX_LEN = 48
LOGIT_RTOL = 5e-2            # of the reference logits' absmax


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here, not at module level)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import deploy as jdeploy
    from repro.models import api as japi
    from repro.serve import pool as jpool
    from repro.serve import registry as jregistry
    from repro.serve import scheduler as jscheduler
    return types.SimpleNamespace(jax=jax, jnp=jnp, deploy=jdeploy, api=japi,
                                 pool=jpool, registry=jregistry,
                                 scheduler=jscheduler)


@pytest.fixture(scope="module")
def cell(J):
    """(JAX model, port model, numpy params): the JAX init with seeded
    non-zero cores."""
    jmodel, _ = J.registry.compile_entry(MODEL_ID)
    params = J.jax.tree.map(np.asarray, jmodel.init(J.jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def cores(tree):
        if isinstance(tree, dict):
            out = {k: cores(v) for k, v in tree.items()}
            if "core" in out.get("sram", {}):
                out["sram"]["core"] = (rng.normal(
                    size=out["sram"]["core"].shape) * 0.3).astype(np.float32)
            return out
        return tree

    return jmodel, registry.compile_entry(MODEL_ID)[0], cores(params)


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=3 + (5 * i) % 17) for i in range(n)]


def _solo(model, params, prompt, n_new):
    """Plain greedy decode of one prompt, batch 1."""
    cache = model.init_cache(1, MAX_LEN, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, cache = model.prefill(
            params, {"tokens": torch.as_tensor(prompt[None])}, cache)
        out = [int(logits[0, -1].argmax())]
        for _ in range(n_new - 1):
            logits, cache = model.decode_step(
                params, torch.tensor([[out[-1]]]), cache)
            out.append(int(logits[0, -1].argmax()))
    return out


def _oracle(refs, vocab, wrong_every=None):
    """A ``draft_source`` proposing the known greedy continuation, wrong at
    every ``wrong_every``-th generated position (the reference's)."""
    def draft(active, tok, k):
        out = np.zeros((tok.shape[0], k), np.int32)
        for slot, req in active.items():
            ref = refs[req.rid]
            pos = len(req.tokens)
            for i in range(k):
                t = ref[pos + i] if pos + i < len(ref) else 0
                if wrong_every and (pos + i) % wrong_every == 0:
                    t = (t + 1) % vocab
                out[slot, i] = t
        return out
    return draft


def _pools(model, paged, n_rows=3):
    if paged:
        return tpool.PagedPool(model, n_rows, 6 * n_rows, 8, MAX_LEN,
                               device="cpu")
    return tpool.SlotPool(model, n_rows, MAX_LEN, device="cpu")


def _adopted(model, params, pool, prompts):
    """Prefill each prompt solo and adopt it into its own pool row; returns
    the first tokens."""
    first = []
    for prompt in prompts:
        row = pool.try_admit(prompt.size + 8)
        with torch.no_grad():
            logits, solo = model.prefill(
                params, {"tokens": torch.as_tensor(prompt[None])},
                pool.solo_cache())
        pool.adopt(row, solo)
        first.append(int(logits[0, -1].argmax()))
    return first


def _jax_adopted(J, jmodel, params, pool, prompts):
    for prompt in prompts:
        row = pool.try_admit(prompt.size + 8)
        _, solo = jmodel.prefill(params, {"tokens": prompt[None]},
                                 pool.solo_cache())
        pool.adopt(row, solo)


# ---------------------------------------------------------------------------
# the model surface: verify, draft, draft_config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_verify_step_logits_match_jax(J, cell, paged):
    """A [3, 4] block over three adopted rows of different lengths."""
    jmodel, model, params = cell
    prompts = _prompts(3, seed=4)
    block = np.random.default_rng(5).integers(0, 512, (3, 4)).astype(np.int32)
    pool = _pools(model, paged)
    tp = bridge.to_torch(params, "cpu")
    _adopted(model, tp, pool, prompts)
    pool.prepare_tokens(4)
    with torch.no_grad():
        got, _ = model.verify_step(tp, torch.as_tensor(block), pool.cache)
    jp = J.jax.tree.map(J.jnp.asarray, params)
    jpool_ = (J.pool.PagedPool(jmodel, 3, 18, 8, MAX_LEN,
                               dtype=J.jnp.float32) if paged
              else J.pool.SlotPool(jmodel, 3, MAX_LEN, dtype=J.jnp.float32))
    _jax_adopted(J, jmodel, jp, jpool_, prompts)
    jpool_.prepare_tokens(4)
    want, _ = jmodel.verify_step(jp, J.jnp.asarray(block), jpool_.cache)
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 4, 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("paged", [False, True])
def test_verify_equals_decode_steps_bitwise(cell, paged):
    """Verify logits at every position equal the decode steps that feed
    the same tokens one at a time, bit for bit, and so do the caches they
    leave behind."""
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    prompts = _prompts(3, seed=6)
    block = np.random.default_rng(7).integers(0, 512, (3, 4)).astype(np.int32)
    verify, stepped = _pools(model, paged), _pools(model, paged)
    _adopted(model, tp, verify, prompts)
    _adopted(model, tp, stepped, prompts)
    verify.prepare_tokens(4)
    with torch.no_grad():
        got, _ = model.verify_step(tp, torch.as_tensor(block), verify.cache)
        for j in range(4):
            stepped.prepare_step()
            want, _ = model.decode_step(
                tp, torch.as_tensor(block[:, j:j + 1]), stepped.cache)
            assert torch.equal(got[:, j], want[:, 0]), f"position {j}"
    for key in ("k", "v", "length"):
        assert torch.equal(verify.cache["layers"][key],
                           stepped.cache["layers"][key]), key


def test_draft_decode_step_logits_match_jax(J, cell):
    """The branch-only draft: a draft prefill, then two draft steps over a
    3-row dense cache (the scheduler's draft pool)."""
    jmodel, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    jp = J.jax.tree.map(J.jnp.asarray, params)
    prompts = _prompts(3, seed=8)
    pool = tpool.SlotPool(model, 3, MAX_LEN, device="cpu")
    jpool_ = J.pool.SlotPool(jmodel, 3, MAX_LEN, dtype=J.jnp.float32)
    for row, prompt in enumerate(prompts):
        with torch.no_grad():
            _, solo = model.draft_prefill(
                tp, {"tokens": torch.as_tensor(prompt[None])},
                pool.solo_cache())
        pool.adopt(row, solo)
        _, jsolo = jmodel.draft_prefill(jp, {"tokens": prompt[None]},
                                        jpool_.solo_cache())
        jpool_.adopt(row, jsolo)
    tok = np.asarray([[3], [77], [400]], np.int32)
    for _ in range(2):
        with torch.no_grad():
            got, _ = model.draft_decode_step(tp, torch.as_tensor(tok),
                                             pool.cache)
        want, jcache = jmodel.draft_decode_step(jp, J.jnp.asarray(tok),
                                                jpool_.cache)
        jpool_.cache = jcache
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=LOGIT_RTOL * np.abs(want).max())
        tok = want[:, -1].argmax(-1).astype(np.int32)[:, None]
    # the draft is another model than the full cell: it skips the trunks
    with torch.no_grad():
        full, _ = model.decode_step(tp, torch.as_tensor(tok),
                                    tpool.SlotPool(model, 3, MAX_LEN,
                                                   device="cpu").cache)
        draft, _ = model.draft_decode_step(
            tp, torch.as_tensor(tok),
            tpool.SlotPool(model, 3, MAX_LEN, device="cpu").cache)
    assert not torch.equal(full, draft)


@pytest.mark.parametrize("overrides", [
    None, {"blocks.mlp": {"memory": "sram"}},
    {"blocks.attn": {"branch_enabled": False}}])
def test_draft_config_flips_the_reference_sites(J, overrides):
    """``draft_config`` sets ``trunk_skip`` at the same sites as the
    reference's: every enabled site, overrides included, and no SRAM site;
    a draft of a draft is the same config."""
    from repro import configs as jconfigs
    from repro.models.config import spec_for as jspec_for
    from repro_torch import configs as tconfigs
    from repro_torch.models.config import spec_for
    from repro_torch import deploy as tdeploy
    tm = tdeploy.compile_model(tconfigs.get_smoke("gemma_2b"),
                               layer_overrides=overrides)
    jm = J.deploy.compile_model(jconfigs.get_smoke("gemma_2b"),
                                layer_overrides=overrides)
    tcfg, jcfg = tm.draft_cfg, jm.draft_cfg
    assert tcfg.rebranch.trunk_skip == jcfg.rebranch.trunk_skip
    tsites = {s: (sp.enabled, sp.trunk_skip)
              for s, sp in tcfg.rebranch_overrides}
    jsites = {s: (sp.enabled, sp.trunk_skip)
              for s, sp in jcfg.rebranch_overrides}
    assert tsites == jsites
    for site in ("blocks.attn", "blocks.mlp"):
        assert spec_for(tcfg, site).trunk_skip == \
            jspec_for(jcfg, site).trunk_skip
    assert J.api.draft_config(jm.cfg) == jcfg
    assert api.draft_config(tcfg) == tcfg
    assert tm.draft_cfg is tcfg                  # built once


# ---------------------------------------------------------------------------
# the scheduler: tokens, counters, blocks
# ---------------------------------------------------------------------------

GENS = [4, 7, 3, 6, 5]


def _jax_tokens(J, jmodel, params, prompts, gens, paged, **kw):
    jp = J.jax.tree.map(J.jnp.asarray, params)
    pool = (J.pool.PagedPool(jmodel, 3, 18, 8, MAX_LEN, dtype=J.jnp.float32)
            if paged else J.pool.SlotPool(jmodel, 3, MAX_LEN,
                                          dtype=J.jnp.float32))
    b = J.scheduler.ContinuousBatcher(jmodel, jp, pool, prefill_chunk=0,
                                      **kw)
    reqs = [b.submit(p, g) for p, g in zip(prompts, gens)]
    b.drain(max_steps=500)
    return [r.tokens for r in reqs]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("drafter", ["branch", "oracle"])
def test_spec_tokens_equal_plain_greedy_and_jax(J, cell, drafter, paged):
    """``spec_k=3`` with the branch-only draft and ``spec_k=4`` with an
    oracle that misses every 3rd position: every request's tokens equal
    its plain greedy decode and the JAX batcher's under the same drafter;
    no block is left behind."""
    jmodel, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    prompts = _prompts(5)
    refs = [_solo(model, tp, p, g) for p, g in zip(prompts, GENS)]
    kw = dict(spec_k=3) if drafter == "branch" else dict(
        spec_k=4, draft_source=_oracle(refs, 512, wrong_every=3))
    pool = _pools(model, paged)
    b = ContinuousBatcher(model, tp, pool, prefill_chunk=0, **kw)
    reqs = [b.submit(p, g) for p, g in zip(prompts, GENS)]
    b.drain(max_steps=500)
    assert [r.tokens for r in reqs] == refs
    assert [r.tokens for r in reqs] == _jax_tokens(J, jmodel, params,
                                                   prompts, GENS, paged, **kw)
    assert b.spec_rounds == b.step_count > 0 and pool.occupancy == 0
    if paged:
        assert pool.blocks_in_use == 0 == pool.blocks_reserved


def test_counters_add_up_and_rounds_shrink(cell):
    """The drafted/matched counters add up over requests; a good draft
    (oracle wrong at every 3rd position) lands more than one token a
    round, so the batch takes fewer rounds than plain decode takes steps."""
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    prompts = _prompts(4, seed=5)
    gens = [6, 8, 5, 7]
    refs = [_solo(model, tp, p, g) for p, g in zip(prompts, gens)]
    b = ContinuousBatcher(model, tp, _pools(model, False, 2), spec_k=4,
                          draft_source=_oracle(refs, 512, wrong_every=3))
    reqs = [b.submit(p, g) for p, g in zip(prompts, gens)]
    b.drain(max_steps=500)
    assert [r.tokens for r in reqs] == refs
    assert 0.0 < b.acceptance_rate < 1.0
    assert b.drafted_total == sum(r.drafted for r in reqs)
    assert b.matched_total == sum(r.matched for r in reqs)
    assert b.acceptance_rate == b.matched_total / b.drafted_total
    for r in reqs:
        assert 0 <= r.matched <= r.drafted <= 4 * len(r.tokens)
    plain = ContinuousBatcher(model, tp, _pools(model, False, 2))
    for p, g in zip(prompts, gens):
        plain.submit(p, g)
    assert b.spec_rounds < plain.drain(max_steps=500)


def test_rejected_drafts_never_leak_blocks(cell):
    """An always-wrong draft rolls the whole tail back every round: the
    tokens stay exact, one lands per round, and the paged pool's granted
    and reserved blocks drain to zero."""
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    prompts = _prompts(3, seed=2)
    gens = [5, 6, 4]
    refs = [_solo(model, tp, p, g) for p, g in zip(prompts, gens)]
    pool = _pools(model, True)
    b = ContinuousBatcher(model, tp, pool, spec_k=4,
                          draft_source=_oracle(refs, 512, wrong_every=1))
    reqs = [b.submit(p, g) for p, g in zip(prompts, gens)]
    high = 0
    while b.step():
        high = max(high, pool.blocks_in_use)
        assert b.step_count < 500
    assert [r.tokens for r in reqs] == refs
    assert b.acceptance_rate == 0.0 and high > 0
    assert pool.blocks_in_use == 0 == pool.blocks_reserved
    assert len(pool._free_blocks) == pool.n_blocks
    assert (pool._table == pool._trash).all()


@pytest.mark.parametrize("paged", [False, True])
def test_k1_round_is_a_decode_step(cell, paged):
    """``spec_k=1``: one verify of width 1 a round, each round a plain
    decode step: the same tokens in the same number of ticks."""
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    prompts = _prompts(4, seed=3)
    runs = []
    for spec_k in (0, 1):
        b = ContinuousBatcher(model, tp, _pools(model, paged), spec_k=spec_k)
        reqs = [b.submit(p, 5) for p in prompts]
        runs.append((b.drain(max_steps=100), [r.tokens for r in reqs]))
    assert runs[0] == runs[1]


def test_eos_mid_block_drops_the_rest(cell):
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    prompt = _prompts(1, seed=7)[0]
    full = _solo(model, tp, prompt, 8)
    b = ContinuousBatcher(model, tp, _pools(model, True), spec_k=4,
                          draft_source=_oracle([full], 512))
    req = b.submit(prompt, 8, eos_id=full[2])
    b.drain(max_steps=20)
    assert req.tokens == full[:full.index(full[2]) + 1]
    assert b.pool.blocks_in_use == 0 == b.pool.blocks_reserved


# ---------------------------------------------------------------------------
# the pools' rollback, against the reference's
# ---------------------------------------------------------------------------

def test_rollback_accounting_equals_the_reference(J, cell):
    """The same admission, prepare_tokens and rollback sequence on both
    packages' paged pools leaves the same blocks, reservations, lengths
    and tables at every stage (``tests/test_serve.py``'s scenario)."""
    jmodel, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    jp = J.jax.tree.map(J.jnp.asarray, params)
    prompt = _prompts(2)[1][:6]              # 6 + 4 spans block 2
    tpl = tpool.PagedPool(model, 2, 12, 8, MAX_LEN, device="cpu")
    jpl = J.pool.PagedPool(jmodel, 2, 12, 8, MAX_LEN, dtype=J.jnp.float32)
    _adopted(model, tp, tpl, [prompt])
    _jax_adopted(J, jmodel, jp, jpl, [prompt])
    start = int(prompt.size)

    def same():
        assert tpl.blocks_in_use == jpl.blocks_in_use
        assert tpl.blocks_reserved == jpl.blocks_reserved
        assert tpl._len == jpl._len and tpl._owed == jpl._owed
        assert tpl._free_blocks == jpl._free_blocks
        np.testing.assert_array_equal(tpl._table, jpl._table)
        np.testing.assert_array_equal(
            tpl.cache["layers"]["length"].numpy(),
            np.asarray(jpl.cache["layers"]["length"]))
        np.testing.assert_array_equal(
            tpl.cache["layers"]["table"].numpy(),
            np.asarray(jpl.cache["layers"]["table"]))

    same()
    before = tpl.blocks_in_use
    for pl in (tpl, jpl):
        pl.prepare_tokens(4)
    same()
    grown = tpl.blocks_in_use
    assert grown > before
    for pl in (tpl, jpl):
        pl.rollback({0: start + 1})
    same()
    assert tpl.blocks_in_use == before and tpl._len[0] == start + 1
    for pl in (tpl, jpl):
        pl.prepare_tokens(4)
    same()
    assert tpl.blocks_in_use == grown
    for pl in (tpl, jpl):
        pl.release(0)
    same()
    assert tpl.blocks_in_use == 0 == tpl.blocks_reserved


def test_rollback_errors_equal_the_reference(J, cell):
    jmodel, model, _ = cell
    for pl in (tpool.PagedPool(model, 2, 12, 8, MAX_LEN, device="cpu"),
               J.pool.PagedPool(jmodel, 2, 12, 8, MAX_LEN)):
        with pytest.raises(ValueError, match="holds no blocks"):
            pl.rollback({0: 5})              # row never admitted
        with pytest.raises(ValueError, match="at least one token"):
            pl.prepare_tokens(0)
        row = pl.try_admit(10)
        pl.prepare_tokens(3)
        with pytest.raises(ValueError, match="only ever truncates"):
            pl.rollback({row: 99})           # growth is not a rollback
        pl.release(row)


def test_dense_rollback_resets_every_layer(cell):
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    pool = tpool.SlotPool(model, 3, MAX_LEN, device="cpu")
    _adopted(model, tp, pool, _prompts(3))
    before = pool.cache["layers"]["k"].clone()
    pool.prepare_tokens(4)                   # dense: nothing to grant
    pool.rollback({0: 2, 2: 5})
    lengths = pool.cache["layers"]["length"]
    assert lengths.shape[0] == model.cfg.num_layers
    assert (lengths[:, 0] == 2).all() and (lengths[:, 2] == 5).all()
    assert (lengths[:, 1] == _prompts(3)[1].size).all()
    assert torch.equal(pool.cache["layers"]["k"], before)
    pool.rollback({})


def test_draft_pool_is_its_own_cache(cell):
    """The branch drafter's shadow cache is a dense pool of its own: it
    shares no tensor with the verify pool."""
    _, model, params = cell
    tp = bridge.to_torch(params, "cpu")
    pool = _pools(model, True)
    b = ContinuousBatcher(model, tp, pool, spec_k=2)
    d = b._draft_pool
    assert isinstance(d, tpool.SlotPool) and d.n_slots == pool.n_slots
    ptrs = {t.data_ptr() for t in pool.cache["layers"].values()}
    assert not ptrs & {t.data_ptr() for t in d.cache["layers"].values()}
    assert ContinuousBatcher(model, tp, pool, spec_k=2,
                             draft_source=lambda *a: None)._draft_pool is None


# ---------------------------------------------------------------------------
# refusals (the reference's texts)
# ---------------------------------------------------------------------------

def test_verify_block_wider_than_horizon_raises(cell):
    _, model, params = cell
    cache = model.init_cache(2, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="horizon"):
        model.verify_step(bridge.to_torch(params, "cpu"),
                          torch.zeros((2, 17), dtype=torch.int32), cache)


def test_spec_refused_where_rollback_cannot_work(cell):
    _, model, params = cell
    swa = types.SimpleNamespace(cfg=dataclasses.replace(model.cfg,
                                                        sliding_window=8))
    assert not api.supports_speculation(swa.cfg)
    assert api.supports_speculation(model.cfg)
    pool = tpool.SlotPool(model, 1, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="spec_k=0"):
        ContinuousBatcher(swa, {}, pool, spec_k=2)
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        ContinuousBatcher(model, {}, pool, spec_k=-1)
    with pytest.raises(ValueError, match="speculative verify"):
        api.verify_step({}, torch.zeros((1, 2), dtype=torch.int32), swa.cfg,
                        None)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_spec_equals_plain_greedy_on_the_card(paged):
    """Gemma-2B smoke under ``pallas_fused`` (kernel 3 behind every ROM
    linear), seeded weights with non-zero cores: speculative tokens with
    the branch drafter and with an oracle drafter equal plain greedy
    decode on the card, bit for bit; the draft launches no kernel, each
    verify round launches kernel 3 once per linear; no block is left."""
    from repro_torch import configs
    from repro_torch.kernels import rebranch_matmul as rm
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: kernel 3 runs only on the card")
    dev = torch.device("cuda")
    model_id = "gemma-2b-smoke-spec-test"
    registry.register(registry.ModelEntry(
        model_id=model_id, config=lambda: configs.get_smoke("gemma_2b"),
        engine="pallas_fused"), override=True)
    model, _ = registry.compile_entry(model_id)
    params = model.init(seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for key, t in bridge.flatten(params).items():
        if key.endswith("['core']"):
            t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.05)
    prompts = _prompts(5, seed=11)
    gens = [6, 9, 4, 8, 7]
    plain = server.load(model_id, params=params, n_slots=3, max_len=MAX_LEN,
                        paged=paged)
    preqs = [plain.submit(p, g) for p, g in zip(prompts, gens)]
    plain.drain()
    refs = [r.tokens for r in preqs]
    per_pass = 7 * model.cfg.num_layers
    for kw in (dict(spec_k=3),
               dict(spec_k=4, draft_source=_oracle(refs, 512, 3))):
        srv = server.load(model_id, params=params, n_slots=3,
                          max_len=MAX_LEN, paged=paged, **kw)
        calls = []

        def counted(name, real):
            def call(*args):
                before = rm.launches
                out = real(*args)
                calls.append((name, rm.launches - before))
                return out
            return call

        for name in ("verify_step", "draft_prefill", "draft_decode_step"):
            setattr(model, name, counted(name, getattr(model, name)))
        try:
            reqs = [srv.submit(p, g) for p, g in zip(prompts, gens)]
            srv.drain()
        finally:
            for name in ("verify_step", "draft_prefill", "draft_decode_step"):
                delattr(model, name)
        assert [r.tokens for r in reqs] == refs
        assert {n for n, _ in calls} >= {"verify_step"}
        for name, launched in calls:
            assert launched == (per_pass if name == "verify_step" else 0), \
                name
        if paged:
            assert srv.pool.blocks_in_use == 0 == srv.pool.blocks_reserved
